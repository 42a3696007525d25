"""Versioned model snapshots and zero-drop hot-swap (the counterpart of
``repro/serve/snapshot.py``).

A ``ModelSnapshot`` is the immutable published unit: the padded primal
``w_pad`` (a dummy slot at index d, the ELL padding convention of
``repro_torch.data.sparse``), the carried duals for the next warm start,
and a version that only increases.  In the port ``w_pad`` and ``alpha``
are tensors on the snapshot's device, made once when the snapshot is
built, so a scoring batch reads w where it lies instead of copying it
over once a batch.  ``SnapshotStore`` is the swap protocol: a scoring
batch *pins* the current version for its lifetime, ``publish`` flips the
pointer first (new pins see the new version at once) and then waits for
the old version's pins to drain, up to a grace — in-flight batches
finish on the snapshot they pinned, so a swap neither drops nor
version-mixes a batch.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple, Optional

import torch

from repro_torch.dist.mesh import resolve_device
from repro_torch.resilience import load_newest_solver_state


class ModelSnapshot(NamedTuple):
    """One published model version, on its device.

    A binary model carries a (d + 1,) padded primal; a K-class
    one-vs-rest model the (K, d + 1) head stack with the same dummy slot
    at column d.  ``n_classes`` is 0 for binary.
    """

    w_pad: torch.Tensor        # (d + 1,) or (K, d + 1) float32
    version: int
    d: int
    alpha: Optional[torch.Tensor] = None   # carried duals (warm start)
    meta: Optional[dict] = None

    @property
    def n_classes(self) -> int:
        return int(self.w_pad.shape[0]) if self.w_pad.dim() == 2 else 0

    @property
    def device(self) -> torch.device:
        return self.w_pad.device


def make_snapshot(w, version: int, *, alpha=None,
                  meta: Optional[dict] = None, device=None) -> ModelSnapshot:
    """A snapshot on ``device`` (the card unless the caller asks for the
    CPU) from an unpadded primal — (d,) binary, or a (K, d) one-vs-rest
    head stack — given as a tensor (on any device) or an array."""
    dev = resolve_device(device)
    w = torch.as_tensor(w).to(device=dev, dtype=torch.float32)
    a = (None if alpha is None
         else torch.as_tensor(alpha).to(device=dev, dtype=torch.float32))
    if w.dim() == 2:
        k, d = int(w.shape[0]), int(w.shape[1])
        w_pad = torch.zeros((k, d + 1), dtype=torch.float32, device=dev)
        w_pad[:, :d] = w
        return ModelSnapshot(w_pad, int(version), d, a, meta)
    w = w.reshape(-1)
    d = int(w.shape[0])
    w_pad = torch.zeros((d + 1,), dtype=torch.float32, device=dev)
    w_pad[:d] = w
    a = None if a is None else a.reshape(-1)
    return ModelSnapshot(w_pad, int(version), d, a, meta)


def snapshot_from_result(result, version: int,
                         meta: Optional[dict] = None) -> ModelSnapshot:
    """Snapshot a solver result — a ``ShardedResult``, or a
    ``ResilientResult`` (unwrapped via its ``.result``) — on the device
    its ŵ lies on, with no trip to the host."""
    inner = getattr(result, "result", result)
    return make_snapshot(inner.w_hat, version, alpha=inner.alpha,
                         meta=meta, device=inner.w_hat.device)


def load_snapshot(ckpt_dir: str, version: int = 0, *,
                  device=None) -> ModelSnapshot:
    """Boot a snapshot on ``device`` from the newest loadable solver
    checkpoint of ``ckpt_dir`` (either package's: the format is the
    same), tolerating a race with the writer's checkpoint GC
    (``load_newest_solver_state`` walks past steps deleted
    mid-read)."""
    dev = resolve_device(device)
    state, step = load_newest_solver_state(ckpt_dir)
    return make_snapshot(
        state["w_canon"], version, alpha=state.get("alpha_canon"),
        meta={"ckpt_step": int(step)}, device=dev)


class SnapshotStore:
    """Atomic publish and per-version pin refcounts.

    Readers: ``snap = store.pin()`` … score … ``store.unpin(
    snap.version)`` (the engine does this in a ``finally``).  Writer:
    ``store.publish(new, grace_s=...)`` — the pointer flip under the
    lock, then a condition wait until every pin of *older* versions
    drains or the grace elapses.  Stragglers past the grace still
    complete on their pinned snapshot (kept alive by their reference) —
    drained late beats dropped.
    """

    def __init__(self, snapshot: ModelSnapshot):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._current = snapshot
        self._pins: dict = {}

    @property
    def version(self) -> int:
        with self._lock:
            return self._current.version

    def current(self) -> ModelSnapshot:
        with self._lock:
            return self._current

    def pin(self) -> ModelSnapshot:
        """Pin the current version for the life of one batch."""
        with self._lock:
            snap = self._current
            self._pins[snap.version] = self._pins.get(snap.version, 0) + 1
            return snap

    def unpin(self, version: int) -> None:
        with self._cond:
            n = self._pins.get(version, 0) - 1
            if n <= 0:
                self._pins.pop(version, None)
            else:
                self._pins[version] = n
            self._cond.notify_all()

    def pinned(self, version: int) -> int:
        with self._lock:
            return self._pins.get(version, 0)

    def publish(self, snapshot: ModelSnapshot, *,
                grace_s: float = 1.0) -> float:
        """Swap to ``snapshot``; returns the drain wait in seconds (the
        hot-swap pause).  Rejects a version that does not increase:
        publishing stale state would roll the model back under live
        traffic."""
        with self._cond:
            if snapshot.version <= self._current.version:
                raise ValueError(
                    f"version must increase: have {self._current.version}, "
                    f"got {snapshot.version}")
            self._current = snapshot  # flip: new pins see it immediately
            t0 = time.monotonic()
            deadline = t0 + max(float(grace_s), 0.0)

            def _drained():
                return not any(v < snapshot.version for v in self._pins)

            while not _drained():
                left = deadline - time.monotonic()
                if left <= 0 or not self._cond.wait(timeout=left):
                    break
            return time.monotonic() - t0
