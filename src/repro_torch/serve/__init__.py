"""The online scoring engine for the linear models (the counterpart of
``repro.serve``'s SVM side): a bounded request queue with backpressure
and deadline shedding, versioned zero-drop snapshot hot-swap, the
occupancy degrade ladder, and drift-triggered warm-start incremental
training.  The language model's prefill and decode steps are not part
of it yet."""

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
    "make_snapshot",
    "snapshot_from_result",
]
