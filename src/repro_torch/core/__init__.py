"""PASSCoDe core on PyTorch: losses, objectives, serial DCD and the 1-D
data-parallel solver (counterpart of ``repro.core``)."""

from repro_torch.core.duals import Hinge, Logistic, SquaredHinge
from repro_torch.core.objective import (
    dual_objective,
    duality_gap,
    predict_accuracy,
    primal_objective,
    w_of_alpha,
)
from repro_torch.core.dcd import dcd_epoch, dcd_solve
from repro_torch.core.sharded import sharded_passcode_solve

__all__ = [
    "Hinge",
    "SquaredHinge",
    "Logistic",
    "dual_objective",
    "primal_objective",
    "duality_gap",
    "predict_accuracy",
    "w_of_alpha",
    "dcd_epoch",
    "dcd_solve",
    "sharded_passcode_solve",
]
