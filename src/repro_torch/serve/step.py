"""The LM serving steps, prefill and decode — thin wrappers around the
model zoo's cache-aware forwards (the counterpart of
``repro/serve/step.py``)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import decode_step, prefill


def make_prefill_step(cfg: ModelConfig):
    """``step(params, batch, cache) -> (logits, cache)``: the whole
    prompt, filling the cache."""

    @torch.no_grad()
    def step(params, batch, cache):
        return prefill(cfg, params, batch, cache)

    return step


def make_decode_step(cfg: ModelConfig):
    """``step(params, batch, cache) -> (token, logits, cache)``: one token
    against the cache; ``token`` (B,) int32 is the greedy argmax over the
    real vocabulary (``[:vocab_size]``, not the padded columns), left on
    the device."""

    @torch.no_grad()
    def step(params, batch, cache):
        logits, cache = decode_step(cfg, params, batch, cache)
        token = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
        return token.to(torch.int32), logits, cache

    return step
