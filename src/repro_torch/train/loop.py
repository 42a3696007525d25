"""The fault-tolerant training loop (the counterpart of
``repro/train/loop.py``):

  * **checkpoint and restart** — a run resumes from the newest
    checkpoint; the data are step-indexed (``data.lm_data``), so no
    iterator state can be lost;
  * **failures** — a step that raises (a lost device, a preemption, an
    injected fault) restores the newest checkpoint and replays from it;
    after ``max_retries`` failures in a row the loop aborts;
  * **stragglers** — a step slower than ``step_deadline_s`` is counted
    and handed to ``on_straggler``;
  * **old checkpoints** are collected, keeping the newest
    ``keep_ckpts``;
  * **elastic scaling** — ``shardings`` places a restored state on a
    live mesh, whatever mesh or world size wrote the checkpoint.

On a live mesh every rank runs its own loop over its shards of the
state.  A step that fails on one rank must fail on all of them before
any enters the step's collectives, or the group would hang or replay
different steps: the ranks take a MAX over a failure flag right after
``fault_hook``, so every rank restores the same checkpoint.  Stragglers
are counted on each rank's own clock.

``float(metrics["loss"])`` is the loop's one host read a step, so a
step's time includes its device work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.dist.collectives import mesh_max
from repro_torch.dist.sharding import is_dtensor
from repro_torch.train.checkpoint import (
    gc_checkpoints,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)


def _mesh_of(state):
    """The live mesh of more than one rank ``state`` lies on, or None."""
    from repro_torch.tree import leaves

    for t in leaves(state):
        if is_dtensor(t) and t.device_mesh.size() > 1:
            return t.device_mesh
    return None


def _agreed_hook(fault_hook, step: int, mesh) -> None:
    """Run ``fault_hook(step)`` (a test hook: it may raise to inject a
    fault), then, on a mesh, agree on the outcome: a MAX over the ranks'
    failure flags, so that where the hook raised on any rank it raises
    on every rank (its own exception, or one naming the step)."""
    import torch

    err = None
    if fault_hook is not None:
        try:
            fault_hook(step)
        except Exception as e:  # noqa: BLE001 — agreed on below
            err = e
    if mesh is not None:
        flag = mesh_max(torch.tensor([int(err is not None)]), mesh)
        if err is None and int(flag[0]):
            err = RuntimeError(f"step {step} failed on another rank")
    if err is not None:
        raise err


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    keep_ckpts: int = 3
    max_retries: int = 3
    step_deadline_s: Optional[float] = None  # the straggler threshold
    log_every: int = 10


@dataclasses.dataclass
class LoopReport:
    final_step: int
    losses: list
    n_failures: int
    n_stragglers: int
    restarts: list


def run_training(
    state,
    step_fn: Callable,  # (state, batch) -> (state, metrics)
    batch_fn: Callable,  # step -> batch
    cfg: LoopConfig,
    *,
    shardings=None,
    fault_hook: Optional[Callable] = None,  # step -> None, or raises
    on_straggler: Optional[Callable] = None,
    log: Callable = print,
) -> tuple[Any, LoopReport]:
    """Run ``step_fn`` from the newest checkpoint (or from ``state``,
    saved as step 0) to ``cfg.total_steps``.  Returns (state, report).
    A deadline of 0 or None counts no straggler, as the reference's
    does.  ``shardings`` (``train.train_state_shardings``) places each
    restored state on its live mesh, as the reference's re-places it on
    a new one; without it a restore gives plain tensors on the
    template's device."""
    start = latest_step(cfg.ckpt_dir)
    restarts = []
    if start is not None:
        state, step = restore_checkpoint(cfg.ckpt_dir, start, state,
                                         shardings)
        restarts.append(("resume", step))
        log(f"[loop] resumed from checkpoint at step {step}")
    else:
        step = 0
        save_checkpoint(cfg.ckpt_dir, 0, state)

    mesh = _mesh_of(state)
    losses = []
    n_failures = 0
    n_stragglers = 0
    consecutive = 0
    while step < cfg.total_steps:
        try:
            _agreed_hook(fault_hook, step, mesh)
            t0 = time.time()
            batch = batch_fn(step)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if cfg.step_deadline_s and dt > cfg.step_deadline_s:
                n_stragglers += 1
                if on_straggler is not None:
                    on_straggler(step, dt)
            losses.append(loss)
            consecutive = 0
            step += 1
            if step % cfg.log_every == 0:
                log(f"[loop] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if step % cfg.ckpt_every == 0:
                save_checkpoint(cfg.ckpt_dir, step, state)
                gc_checkpoints(cfg.ckpt_dir, cfg.keep_ckpts)
        except Exception as e:  # noqa: BLE001 — any step failure
            n_failures += 1
            consecutive += 1
            if consecutive > cfg.max_retries:
                raise RuntimeError(
                    f"aborting: {consecutive} consecutive step failures"
                ) from e
            last = latest_step(cfg.ckpt_dir)
            log(f"[loop] step {step} FAILED ({e!r}); restoring ckpt {last}")
            state, step = restore_checkpoint(cfg.ckpt_dir, last, state,
                                             shardings)
            restarts.append(("failure", step))
    save_checkpoint(cfg.ckpt_dir, step, state)
    gc_checkpoints(cfg.ckpt_dir, cfg.keep_ckpts)
    return state, LoopReport(step, losses, n_failures, n_stragglers,
                             restarts)
