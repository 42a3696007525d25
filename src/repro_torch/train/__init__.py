"""The LM trainer — the train step, the fault-tolerant loop — and the
checkpoints of the trainer and the solver (the counterpart of
``repro.train``)."""

from repro_torch.train.checkpoint import (
    available_steps,
    gc_checkpoints,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.loop import LoopConfig, LoopReport, run_training
from repro_torch.train.step import (
    TrainState,
    cross_entropy,
    init_train_state,
    make_train_step,
    train_state_for,
    train_state_shardings,
    train_state_specs,
)

__all__ = ["available_steps", "gc_checkpoints", "latest_step",
           "restore_checkpoint", "save_checkpoint", "LoopConfig",
           "LoopReport", "run_training", "TrainState", "cross_entropy",
           "init_train_state", "make_train_step", "train_state_for",
           "train_state_shardings", "train_state_specs"]
