"""PASSCoDe core on PyTorch: losses, objectives, serial DCD, the
Lock/Atomic/Wild simulation with its backward-error report, and the
data-parallel solver (counterpart of ``repro.core``).

The solvers load on first use: they import the kernel layer, whose
modules import ``repro_torch.core.duals``, so an eager import here would
run in a circle when a kernel module is imported first."""

import importlib

from repro_torch.core.duals import Hinge, Logistic, SquaredHinge
from repro_torch.core.objective import (
    dual_objective,
    duality_gap,
    multiclass_accuracy,
    predict_accuracy,
    predict_multiclass,
    primal_objective,
    w_of_alpha,
)

_LAZY = {"dcd_epoch": "repro_torch.core.dcd",
         "dcd_solve": "repro_torch.core.dcd",
         "passcode_epoch": "repro_torch.core.passcode",
         "passcode_solve": "repro_torch.core.passcode",
         "PasscodeResult": "repro_torch.core.passcode",
         "backward_error_report": "repro_torch.core.backward_error",
         "sharded_passcode_solve": "repro_torch.core.sharded"}

__all__ = [
    "Hinge",
    "SquaredHinge",
    "Logistic",
    "dual_objective",
    "primal_objective",
    "duality_gap",
    "predict_accuracy",
    "predict_multiclass",
    "multiclass_accuracy",
    "w_of_alpha",
    "dcd_epoch",
    "dcd_solve",
    "passcode_epoch",
    "passcode_solve",
    "PasscodeResult",
    "backward_error_report",
    "sharded_passcode_solve",
]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
