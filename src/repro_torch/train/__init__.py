"""The solver's checkpoints (counterpart of ``repro.train``'s
``checkpoint`` module; the language-model trainer is not ported)."""

from repro_torch.train.checkpoint import (
    available_steps,
    gc_checkpoints,
    latest_step,
    save_checkpoint,
)

__all__ = ["available_steps", "gc_checkpoints", "latest_step",
           "save_checkpoint"]
