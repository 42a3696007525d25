"""Optimizers, LR schedules and gradient compression (the counterpart of
``repro.optim``)."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.grad_compress import (
    CompressState,
    compress_init,
    compressed_grads,
)
from repro_torch.optim.schedules import make_schedule

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "make_schedule",
    "CompressState",
    "compress_init",
    "compressed_grads",
]
