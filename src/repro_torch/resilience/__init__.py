"""Fault tolerance for the pipelined solver (the counterpart of
``repro.resilience``): the segmented solve with checkpoint and resume
around the carried-state epoch loop, the on-device divergence watchdog
and the degradation ladder, and the deterministic fault harness that
drives every recovery path."""

from repro_torch.resilience.faults import FaultPlan, corrupt_payload
from repro_torch.resilience.segmented import ResilientResult, solve_segmented
from repro_torch.resilience.state import (
    SolverDiverged,
    drain_state,
    load_newest_solver_state,
    load_solver_state,
)

__all__ = [
    "FaultPlan",
    "ResilientResult",
    "SolverDiverged",
    "corrupt_payload",
    "drain_state",
    "load_newest_solver_state",
    "load_solver_state",
    "solve_segmented",
]
