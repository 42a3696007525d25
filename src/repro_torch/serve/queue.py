"""Bounded request queue for the serving engine (the counterpart of
``repro/serve/queue.py``, plain Python and numpy, the same semantics).

Every request admitted here reaches exactly one *terminal outcome* — a
``ScoreOutcome`` or a structured ``RequestShed`` — delivered through a
``Ticket``.  Nothing is ever silently dropped: refusal at the mouth
(backpressure, invalid payload, expired-before-admission) sheds with a
reason, and ``take`` pops deadline-expired requests out of the queue so
the engine can shed them instead of scoring work nobody is waiting for.

Thread model: producers call ``offer`` from request threads, the single
engine loop calls ``take``; one lock guards the deque, tickets carry
their own ``threading.Event`` so resolution never holds the queue lock.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np


class ScoreOutcome(NamedTuple):
    """Successful terminal outcome of one request.

    Binary models fill ``score`` only.  K-class snapshots additionally
    set ``label`` (argmax head) and ``margins`` (all K per-head scores);
    ``score`` is then the winning head's margin.  ``label`` is -1 for
    binary outcomes.
    """

    rid: int
    score: float
    version: int          # snapshot version that produced the score
    latency_s: float
    label: int = -1
    margins: tuple = ()


class RequestShed(NamedTuple):
    """Structured shed outcome — the *other* terminal state.  ``reason``
    ∈ {"deadline", "backpressure", "invalid", "shutdown"}."""

    rid: int
    reason: str
    detail: str = ""


class Ticket:
    """One-shot future handed back by ``ServeEngine.submit``."""

    __slots__ = ("_event", "_outcome")

    def __init__(self):
        self._event = threading.Event()
        self._outcome = None

    def resolve(self, outcome) -> None:
        if self._outcome is None:  # first writer wins; terminal
            self._outcome = outcome
            self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block for the terminal outcome; raises ``TimeoutError`` if
        it has not arrived within ``timeout`` seconds."""
        if not self._event.wait(timeout):
            raise TimeoutError("request still in flight")
        return self._outcome


@dataclass
class Request:
    """An admitted request: sparse features + deadline + its ticket."""

    rid: int
    cols: np.ndarray       # (k,) int32 column ids, k <= engine k_max
    vals: np.ndarray       # (k,) float32
    deadline: float        # absolute monotonic time
    ticket: Ticket = field(default_factory=Ticket)
    enqueued: float = 0.0


class BoundedRequestQueue:
    """FIFO with a hard depth bound and deadline-aware draining."""

    def __init__(self, depth: int):
        self.depth = int(depth)
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._q: deque = deque()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def occupancy(self) -> float:
        """Queue fill in [0, 1] — the ``serve_rung`` input signal."""
        return len(self) / self.depth

    def offer(self, req: Request) -> bool:
        """Admit unless full.  Returns False when the bound is hit —
        the caller sheds with a backpressure outcome; the queue itself
        never grows past ``depth``."""
        with self._lock:
            if len(self._q) >= self.depth:
                return False
            req.enqueued = time.monotonic()
            self._q.append(req)
            return True

    def take(self, max_batch: int, now: Optional[float] = None):
        """Pop up to ``max_batch`` live requests in FIFO order, plus
        every already-expired request encountered on the way (returned
        separately so the engine sheds them with a deadline outcome)."""
        now = time.monotonic() if now is None else now
        live, expired = [], []
        with self._lock:
            while self._q and len(live) < int(max_batch):
                req = self._q.popleft()
                (expired if req.deadline <= now else live).append(req)
            return live, expired

    def drain(self):
        """Pop everything (shutdown path)."""
        with self._lock:
            out = list(self._q)
            self._q.clear()
            return out
