"""``input_specs()`` — meta-device stand-ins for every model input of
every (arch × shape) cell, and their shardings (the counterpart of
``repro/launch/specs.py``'s ``ShapeDtypeStruct``s).  Shapes and dtypes,
no allocation.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.dist.sharding import batch_sharding, cache_shardings
from repro_torch.models.transformer import cache_max_len, init_cache

I32 = torch.int32
BF16 = torch.bfloat16


def _sd(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Model-input stand-ins for one cell (no cache)."""
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    specs = {}
    if kind == "decode":
        if cfg.embeds_in and not cfg.is_encdec:
            specs["embeds"] = _sd((B, 1, cfg.d_model), BF16)
        else:
            specs["tokens"] = _sd((B, 1), I32)
        if cfg.mrope_sections:
            specs["positions"] = _sd((3, B, 1), I32)
        return specs
    # train / prefill — full sequence
    if cfg.embeds_in and not cfg.is_encdec:
        specs["embeds"] = _sd((B, S, cfg.d_model), BF16)
    else:
        specs["tokens"] = _sd((B, S), I32)
    if cfg.mrope_sections:
        specs["positions"] = _sd((3, B, S), I32)
    if cfg.is_encdec:
        specs["enc_embeds"] = _sd((B, cfg.enc_len, cfg.d_model), BF16)
    if kind == "train":
        specs["labels"] = _sd((B, S), I32)
    return specs


def batch_shardings_for(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    B = shape.global_batch
    out = {}
    for k, v in batch_specs(cfg, shape).items():
        leading = 1 if k == "positions" and v.shape[0] == 3 else 0
        out[k] = batch_sharding(mesh, B, v.dim(), leading=leading)
    return out


def cache_specs(cfg: ModelConfig, shape: InputShape):
    """Decode-cache stand-ins (the cache holds seq_len tokens)."""
    return init_cache(cfg, shape.global_batch, cache_max_len(shape.seq_len),
                      BF16, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape, mesh=None
                ) -> Tuple[dict, dict]:
    """(specs, shardings) for the cell's model inputs.  For decode cells
    the cache specs/shardings are produced by ``cache_specs`` /
    ``cache_shardings_for`` and passed as a separate argument."""
    specs = batch_specs(cfg, shape)
    shardings = batch_shardings_for(cfg, shape, mesh) if mesh else None
    return specs, shardings


def cache_shardings_for(cfg: ModelConfig, shape: InputShape, mesh):
    return cache_shardings(cfg, mesh, cache_specs(cfg, shape),
                           shape.global_batch)
