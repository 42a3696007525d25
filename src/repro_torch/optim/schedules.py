"""LR schedules: cosine, linear and WSD (warmup-stable-decay, the
MiniCPM schedule [arXiv:2404.06395] that the minicpm-2b config selects)
— the counterpart of ``repro/optim/schedules.py``.

A schedule maps a step to a float32 learning rate.  The step may be a
Python int or a 0-d tensor; a tensor's lr is a 0-d float32 tensor on its
device, computed there with no read back to the host.
"""

from __future__ import annotations

import math

import torch


def _as_f32(step) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def make_schedule(kind: str, *, peak_lr: float, total_steps: int,
                  warmup_steps: int = 0, final_frac: float = 0.1,
                  stable_frac: float = 0.8):
    """Returns step → lr."""
    warmup_steps = max(warmup_steps, 1)

    def warmup(step):
        # step + 1, so that the first step's lr is not zero
        return peak_lr * torch.clamp((step + 1.0) / warmup_steps, max=1.0)

    def ramp(step, start, end):
        return torch.clamp((step - start) / max(end - start, 1), 0.0, 1.0)

    if kind == "cosine":

        def lr(step):
            step = _as_f32(step)
            t = ramp(step, warmup_steps, total_steps)
            cos = final_frac + (1 - final_frac) * 0.5 * (
                1 + torch.cos(math.pi * t))
            return torch.where(step < warmup_steps, warmup(step),
                               peak_lr * cos)

        return lr
    if kind == "linear":

        def lr(step):
            step = _as_f32(step)
            t = ramp(step, warmup_steps, total_steps)
            return torch.where(step < warmup_steps, warmup(step),
                               peak_lr * (1 - (1 - final_frac) * t))

        return lr
    if kind == "wsd":
        stable_end = warmup_steps + int(
            (total_steps - warmup_steps) * stable_frac)

        def lr(step):
            step = _as_f32(step)
            decay_t = ramp(step, stable_end, total_steps)
            # the fast decay phase, a float32 power (MiniCPM decays over
            # about a tenth of the steps)
            decay = torch.pow(torch.tensor(final_frac, dtype=torch.float32,
                                           device=step.device), decay_t)
            return torch.where(
                step < warmup_steps, warmup(step),
                torch.where(step < stable_end,
                            torch.full_like(step, peak_lr),
                            peak_lr * decay))

        return lr
    raise ValueError(kind)
