"""The LM serving steps, prefill and decode — thin wrappers around the
model zoo's cache-aware forwards (the counterpart of
``repro/serve/step.py``)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import NO_RULES, is_dtensor, on_mesh
from repro_torch.models.transformer import decode_step, prefill


def make_prefill_step(cfg: ModelConfig, rules=NO_RULES):
    """``step(params, batch, cache) -> (logits, cache)``: the whole
    prompt, filling the cache; ``rules`` places the activations on a
    mesh (the dry-run's fake one, or a live one whose parameters and
    cache are DTensors placed by ``dist.sharding.place`` under
    ``param_shardings`` and ``cache_shardings``)."""

    @torch.no_grad()
    def step(params, batch, cache):
        with on_mesh(rules):
            return prefill(cfg, params, batch, cache, rules)

    return step


def make_decode_step(cfg: ModelConfig, rules=NO_RULES):
    """``step(params, batch, cache) -> (token, logits, cache)``: one token
    against the cache; ``token`` (B,) int32 is the greedy argmax over the
    real vocabulary (``[:vocab_size]``, not the padded columns), left on
    the device."""

    @torch.no_grad()
    def step(params, batch, cache):
        with on_mesh(rules):
            return _decode(params, batch, cache)

    def _decode(params, batch, cache):
        logits, cache = decode_step(cfg, params, batch, cache, rules)
        last = logits[:, -1, :]
        if is_dtensor(last):
            # the vocabulary gathered (DTensor's split argmax breaks on
            # a 2-D batch split), the padded columns masked, not sliced
            from torch.distributed.tensor import Replicate

            last = last.redistribute(last.device_mesh, [
                Replicate() if getattr(p, "dim", None) == 1 else p
                for p in last.placements])
            real = torch.arange(last.shape[-1], device=last.device)
            last = torch.where(real < cfg.vocab_size, last, -torch.inf)
        else:
            last = last[:, :cfg.vocab_size]
        token = torch.argmax(last, dim=-1)
        return token.to(torch.int32), logits, cache

    return step
