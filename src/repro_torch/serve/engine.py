"""The online scoring engine (the counterpart of
``repro/serve/engine.py``).

One loop batches queued requests into a single gather-and-sum dispatch
against the pinned model snapshot — the serving analogue of the paper's
stale-read tolerance: scorers read a (possibly slightly stale) published
w while warm-start incremental solves run beside them, as PASSCoDe
threads read a stale shared primal.

In request order, as in the reference:

  * the *mouth* validates every payload (finite values, shape and
    ``k_max`` bounds, column ids in range) — a bad request is shed with
    ``RequestShed("invalid")`` instead of poisoning the shared batch;
  * admission is deadline-aware and backpressured: an expired deadline
    sheds at once, a full ``BoundedRequestQueue`` sheds with
    ``"backpressure"``;
  * the loop walks ``serve_degrade_ladder`` on queue occupancy (with
    ``serve_rung``'s hysteresis): full batch → quarter batch →
    stale-model-only while the trainer catches up;
  * scoring pins a snapshot version per batch (``SnapshotStore``), so a
    concurrent ``publish`` neither drops nor version-mixes a batch;
  * every request reaches exactly one terminal outcome — ``stop`` drains
    the queue and sheds what is left with ``"shutdown"``.

The dispatch has a fixed shape (``max_batch``, ``k_max``): the ladder
lowers only the live row count, and the sentinel padding (column id d →
the dummy slot) makes unused slots inert.  A batch is staged in one
preallocated host buffer (pinned when the engine is on the card) that
holds the column ids and the values' bits side by side, copied to the
device in one transfer; the (K, B) margins come back in one read, and
the outcomes are built from that one numpy array.  The snapshot's
``w_pad`` stays on the device.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.mesh import (
    resolve_device,
    serve_admission_policy,
    serve_degrade_ladder,
    serve_rung,
)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import (
    BoundedRequestQueue,
    Request,
    RequestShed,
    ScoreOutcome,
    Ticket,
)
from repro_torch.serve.snapshot import (
    ModelSnapshot,
    SnapshotStore,
    snapshot_from_result,
)


def score_batch(w_pad: torch.Tensor, cols: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """(K, B) margins of B fixed-shape (B, k_max) ELL rows against a
    (d + 1,) binary or (K, d + 1) one-vs-rest padded primal (K = 1 for
    binary): one gather contracted over the nonzero axis."""
    w2 = w_pad if w_pad.dim() == 2 else w_pad[None]
    return torch.sum(w2[:, cols.long()] * vals[None], dim=-1)


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current card's ``cuda:i``, so devices compare."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class ServeEngine:
    """Batched scoring over a ``SnapshotStore`` on ``device`` (the card
    unless the caller asks for the CPU), with an optional
    ``IncrementalTrainer`` for drift-triggered warm-start re-solves."""

    def __init__(self, store: SnapshotStore, *, k_max: int,
                 max_batch: int = 64, queue_depth: int = 256,
                 default_deadline_s: float = 0.5,
                 swap_grace_s: float = 0.5, trainer=None,
                 batch_wait_s: float = 0.002, auto_train: bool = False,
                 device=None):
        knobs = serve_admission_policy(
            queue_depth=queue_depth, max_batch=max_batch,
            deadline_s=default_deadline_s, swap_grace_s=swap_grace_s)
        self.device = _indexed(resolve_device(device))
        self.store = store
        self._check_device(store.current())
        self.k_max = int(k_max)
        if self.k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {k_max}")
        self.max_batch = knobs["max_batch"]
        self.default_deadline_s = knobs["deadline_s"]
        self.swap_grace_s = knobs["swap_grace_s"]
        self.queue = BoundedRequestQueue(knobs["queue_depth"])
        self.metrics = ServeMetrics()
        self.trainer = trainer
        self.batch_wait_s = float(batch_wait_s)
        self.auto_train = bool(auto_train)
        # the host staging buffer (engine loop only): column ids in
        # plane 0, the values' float32 bits in plane 1, one transfer
        self._stage = torch.empty(
            (2, self.max_batch, self.k_max), dtype=torch.int32,
            pin_memory=self.device.type == "cuda")
        stage = self._stage.numpy()
        self._cols, self._vals = stage[0], stage[1].view(np.float32)
        self._rung = 0
        self._rid = 0
        self._rid_lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._accepting = True

    def _check_device(self, snap: ModelSnapshot) -> None:
        if _indexed(snap.device) != self.device:
            raise ValueError(
                f"snapshot v{snap.version} lies on {snap.device}, the "
                f"engine scores on {self.device}")

    # ------------------------------------------------- admission ----

    def _next_rid(self) -> int:
        with self._rid_lock:
            self._rid += 1
            return self._rid

    def _pack(self, d: int, features, cols, vals):
        """Validate one payload into (cols, vals) ≤ k_max entries.
        Raises ``ValueError`` with the shed detail on anything that
        would poison the shared batch."""
        if features is not None:
            f = np.asarray(features, np.float32).reshape(-1)
            if f.shape[0] != d:
                raise ValueError(
                    f"expected {d} features, got {f.shape[0]}")
            if not np.all(np.isfinite(f)):
                raise ValueError("non-finite feature values")
            (c,) = np.nonzero(f)
            if c.shape[0] > self.k_max:
                raise ValueError(
                    f"{c.shape[0]} nonzeros > k_max={self.k_max}")
            return c.astype(np.int32), f[c]
        c = np.asarray(cols, np.int64).reshape(-1)
        v = np.asarray(vals, np.float32).reshape(-1)
        if c.shape[0] != v.shape[0]:
            raise ValueError(f"{c.shape[0]} ids vs {v.shape[0]} values")
        if c.shape[0] > self.k_max:
            raise ValueError(f"{c.shape[0]} nonzeros > k_max={self.k_max}")
        if c.size and (c.min() < 0 or c.max() >= d):
            raise ValueError(f"column id out of range [0, {d})")
        if not np.all(np.isfinite(v)):
            raise ValueError("non-finite feature values")
        return c.astype(np.int32), v

    def submit(self, features=None, *, cols=None, vals=None,
               deadline_s: Optional[float] = None) -> Ticket:
        """Admit one scoring request.  Always returns a ``Ticket`` that
        reaches a terminal outcome; invalid, expired and overload
        requests are shed at once with the reason."""
        rid = self._next_rid()
        ticket = Ticket()
        if not self._accepting:
            ticket.resolve(RequestShed(rid, "shutdown", "engine stopped"))
            self.metrics.record_shed("shutdown")
            return ticket
        d = self.store.current().d
        try:
            c, v = self._pack(d, features, cols, vals)
        except ValueError as e:
            ticket.resolve(RequestShed(rid, "invalid", str(e)))
            self.metrics.record_shed("invalid")
            return ticket
        ttl = self.default_deadline_s if deadline_s is None else float(
            deadline_s)
        now = time.monotonic()
        req = Request(rid, c, v, now + ttl, ticket)
        if ttl <= 0:
            ticket.resolve(RequestShed(rid, "deadline",
                                       "expired before admission"))
            self.metrics.record_shed("deadline")
            return ticket
        if not self.queue.offer(req):
            ticket.resolve(RequestShed(rid, "backpressure", "queue full"))
            self.metrics.record_shed("backpressure")
            return ticket
        self._work.set()
        return ticket

    # ------------------------------------------------ engine loop ----

    def _dispatch(self, snap: ModelSnapshot) -> np.ndarray:
        """The staged batch's (K, max_batch) margins against ``snap``:
        one host-to-device copy, the gather-and-sum, one read back."""
        stage = self._stage.to(self.device, non_blocking=True)
        margins = score_batch(snap.w_pad, stage[0],
                              stage[1].view(torch.float32))
        return margins.cpu().numpy()

    def step(self, now: Optional[float] = None) -> int:
        """One engine iteration: walk the degrade ladder, shed the
        expired, score one pinned batch.  Synchronous — the background
        loop is this on a thread; tests drive it directly.  Returns the
        number of requests scored."""
        self._rung = serve_rung(self.queue.occupancy(), self._rung)
        knobs = serve_degrade_ladder(self._rung, max_batch=self.max_batch)
        now = time.monotonic() if now is None else now
        live, expired = self.queue.take(knobs["max_batch"], now)
        for req in expired:
            req.ticket.resolve(RequestShed(req.rid, "deadline",
                                           "expired in queue"))
        if expired:
            self.metrics.record_shed("deadline", len(expired))
        if not live:
            return 0
        snap = self.store.pin()
        try:
            cols, vals = self._cols, self._vals
            cols[:] = snap.d  # sentinel: unused slots hit the dummy slot
            vals[:] = 0.0
            for i, req in enumerate(live):
                k = req.cols.shape[0]
                cols[i, :k] = req.cols
                vals[i, :k] = req.vals
            # read back before the unpin: a publish may then drop w_pad
            margins = self._dispatch(snap)  # (K, B); K = 1 binary
            multiclass = snap.w_pad.dim() == 2
            labels = margins.argmax(axis=0).tolist()
            rows = margins.T.tolist()
            done = time.monotonic()
            lats = []
            for i, req in enumerate(live):
                lat = done - req.enqueued
                if multiclass:
                    out = ScoreOutcome(req.rid, rows[i][labels[i]],
                                       snap.version, lat, labels[i],
                                       tuple(rows[i]))
                else:
                    out = ScoreOutcome(req.rid, rows[i][0], snap.version,
                                       lat)
                req.ticket.resolve(out)
                lats.append(lat)
            self.metrics.record_batch(lats, self._rung)
        finally:
            self.store.unpin(snap.version)
        return len(live)

    def _loop(self):
        while not self._stop.is_set():
            n = self.step()
            if n == 0:
                if self.auto_train and self.trainer is not None:
                    self.train_if_drifted()
                self._work.clear()
                self._work.wait(self.batch_wait_s)

    def start(self):
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-engine", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True):
        """Stop the loop.  ``drain`` scores what is queued; anything
        still left afterwards is shed with ``"shutdown"`` — every
        admitted request still reaches a terminal outcome."""
        self._accepting = False
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if drain:
            while len(self.queue):
                self.step()
        leftovers = self.queue.drain()
        for req in leftovers:
            req.ticket.resolve(RequestShed(req.rid, "shutdown",
                                           "engine stopped"))
        if leftovers:
            self.metrics.record_shed("shutdown", len(leftovers))

    # -------------------------------------------- train / publish ----

    def publish(self, snapshot: ModelSnapshot) -> float:
        """Hot-swap to ``snapshot``; returns the drain pause (s).  A
        snapshot on another device than the engine's raises."""
        self._check_device(snapshot)
        pause = self.store.publish(snapshot, grace_s=self.swap_grace_s)
        self.metrics.record_swap(pause)
        return pause

    def ingest(self, rows, y) -> int:
        """Stream freshly labeled rows to the trainer's buffer."""
        if self.trainer is None:
            raise RuntimeError("engine has no trainer attached")
        return self.trainer.add_labeled(rows, y)

    def train_if_drifted(self, force: bool = False,
                         epochs: Optional[int] = None):
        """Warm-start re-solve and hot-swap when the drift statistic
        trips (or ``force``).  Blocked at ladder rung 2 (stale-model-
        only).  A failed solve (retry budget exhausted) publishes
        nothing — serving stays on the last healthy snapshot."""
        if self.trainer is None:
            return None
        knobs = serve_degrade_ladder(self._rung, max_batch=self.max_batch)
        if not knobs["train"] and not force:
            return None
        if not force and not self.trainer.drifted():
            return None
        res = self.trainer.resolve(epochs=epochs)
        if res is None:
            return None
        self.publish(snapshot_from_result(res, self.store.version + 1))
        return res

    # ----------------------------------------------------- health ----

    def health(self) -> dict:
        out = self.metrics.snapshot()
        out.update({
            "queue_len": len(self.queue),
            "occupancy": self.queue.occupancy(),
            "rung": self._rung,
            "version": self.store.version,
            "accepting": self._accepting,
        })
        if self.trainer is not None:
            out["trainer"] = dict(self.trainer.ledger)
            out["pending_rows"] = self.trainer.pending_rows
        return out
