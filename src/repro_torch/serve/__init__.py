"""Serving (the counterpart of ``repro.serve``): the online scoring
engine for the linear models — a bounded request queue with
backpressure and deadline shedding, versioned zero-drop snapshot
hot-swap, the occupancy degrade ladder, and drift-triggered warm-start
incremental training — and the language model's prefill and decode
steps (``make_prefill_step``, ``make_decode_step``)."""

from repro_torch.serve.engine import ServeEngine
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
    load_snapshot,
    make_snapshot,
    snapshot_from_result,
)
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.serve.trainer import IncrementalTrainer

__all__ = [
    "BoundedRequestQueue",
    "IncrementalTrainer",
    "ModelSnapshot",
    "Request",
    "RequestShed",
    "ScoreOutcome",
    "ServeEngine",
    "ServeMetrics",
    "SnapshotStore",
    "Ticket",
    "load_snapshot",
    "make_decode_step",
    "make_prefill_step",
    "make_snapshot",
    "snapshot_from_result",
]
