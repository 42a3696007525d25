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
    ``keep_ckpts``.

``float(metrics["loss"])`` is the loop's one host read a step, so a
step's time includes its device work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.train.checkpoint import (
    gc_checkpoints,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)


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
    fault_hook: Optional[Callable] = None,  # step -> None, or raises
    on_straggler: Optional[Callable] = None,
    log: Callable = print,
) -> tuple[Any, LoopReport]:
    """Run ``step_fn`` from the newest checkpoint (or from ``state``,
    saved as step 0) to ``cfg.total_steps``.  Returns (state, report).
    A deadline of 0 or None counts no straggler, as the reference's
    does.  The reference's ``shardings`` re-place a restored state on a
    new mesh; on one card there is none to take."""
    start = latest_step(cfg.ckpt_dir)
    restarts = []
    if start is not None:
        state, step = restore_checkpoint(cfg.ckpt_dir, start, state)
        restarts.append(("resume", step))
        log(f"[loop] resumed from checkpoint at step {step}")
    else:
        step = 0
        save_checkpoint(cfg.ckpt_dir, 0, state)

    losses = []
    n_failures = 0
    n_stragglers = 0
    consecutive = 0
    while step < cfg.total_steps:
        try:
            if fault_hook is not None:
                fault_hook(step)  # a test hook: may raise to inject a fault
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
            state, step = restore_checkpoint(cfg.ckpt_dir, last, state)
            restarts.append(("failure", step))
    save_checkpoint(cfg.ckpt_dir, step, state)
    gc_checkpoints(cfg.ckpt_dir, cfg.keep_ckpts)
    return state, LoopReport(step, losses, n_failures, n_stragglers,
                             restarts)
