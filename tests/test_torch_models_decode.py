"""The port's ``prefill`` and ``decode_step`` against the reference's on
every smoke config, in float32 at rtol/atol 1e-4 (``_lm_cases``):
prefill's last-position logits and the cache it fills, and one decode
step's logits and cache from one common cache — the reference's filled
cache carried across (``cache_from_numpy``).  The port's own chain,
prefill then decode, is also held to its teacher-forced logits at
positions S − 1 and S (the reference's 2e-3), and the converters'
round trips are exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_smoke_config
from repro.models import decode_step as ref_decode
from repro.models import init_cache as ref_init_cache
from repro.models import prefill as ref_prefill
from repro.models.transformer import cache_max_len
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.convert import (
    cache_from_numpy,
    cache_to_numpy,
    params_to_numpy,
)
from repro_torch.models import decode_step, forward_train, init_cache, prefill

from _lm_cases import B, S, batch, close, port_params, ref_params


def _split(cfg, full):
    """The prompt's first S positions and the next token's inputs."""
    pre = {k: (v[..., :S] if k == "positions" else
               v[:, :S] if k in ("tokens", "embeds") else v)
           for k, v in full.items()}
    step = {}
    if "tokens" in full:
        step["tokens"] = full["tokens"][:, S:S + 1]
    else:
        step["embeds"] = full["embeds"][:, S:S + 1]
    if cfg.mrope_sections:
        step["positions"] = np.full((3, B, 1), S, np.int32)
    return pre, step


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in d.items()}


def _close_cache(port, ref):
    got = cache_to_numpy(port)
    for f in ("attn_k", "attn_v", "cross_k", "cross_v"):
        want = getattr(ref, f)
        assert (got[f] is None) == (want is None), f
        if want is not None:
            close(got[f], want)
    assert (got["ssm"] is None) == (ref.ssm is None)
    if ref.ssm is not None:
        for f in ("h", "conv_x", "conv_bc"):
            close(got["ssm"][f], getattr(ref.ssm, f))
    assert int(got["length"]) == int(ref.length)


@functools.lru_cache(maxsize=None)
def _ref_prefilled(arch):
    cfg = get_smoke_config(arch)
    pre, step = _split(cfg, batch(cfg, extra=1))
    cache = ref_init_cache(cfg, B, cache_max_len(S), dtype=jnp.float32)
    logits, cache = ref_prefill(cfg, ref_params(arch), _jnp(pre), cache)
    return cfg, pre, step, logits, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    cfg, pre, _, want, want_cache = _ref_prefilled(arch)
    pcfg = port_smoke_config(arch)
    cache = init_cache(pcfg, B, cache_max_len(S), dtype=torch.float32,
                       device="cpu")
    got, cache = prefill(pcfg, port_params(arch), _torch(pre), cache)
    assert got.shape == want.shape
    close(got, want)
    _close_cache(cache, want_cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    cfg, _, step, _, ref_cache = _ref_prefilled(arch)
    port_cache = cache_from_numpy(jax.tree.map(np.asarray, ref_cache),
                                  device="cpu")
    want, want_cache = ref_decode(cfg, ref_params(arch), _jnp(step),
                                  ref_cache)
    got, cache = decode_step(port_smoke_config(arch), port_params(arch),
                             _torch(step), port_cache)
    close(got, want)
    _close_cache(cache, want_cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_forward(arch):
    """The port's own chain against its teacher-forced logits, the
    reference's smoke check (2e-3, ``tests/test_models_smoke.py``)."""
    pcfg = port_smoke_config(arch)
    full = batch(pcfg, seed=4, extra=1)
    pre, step = _split(pcfg, full)
    params = port_params(arch)
    ref_logits, _ = forward_train(pcfg, params, _torch(full),
                                  moe_no_drop=True)
    cache = init_cache(pcfg, B, cache_max_len(S), dtype=torch.float32,
                       device="cpu")
    logits, cache = prefill(pcfg, params, _torch(pre), cache)
    close(logits[:, 0], ref_logits[:, S - 1].numpy(), 2e-3, 2e-3)
    logits, cache = decode_step(pcfg, params, _torch(step), cache)
    close(logits[:, 0], ref_logits[:, S].numpy(), 2e-3, 2e-3)
    assert cache.length == S + 1


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "whisper-small"])
def test_converters_round_trip(arch):
    """``params_to_numpy`` inverts ``params_from_numpy`` exactly, and
    ``cache_to_numpy`` inverts ``cache_from_numpy``."""
    back = params_to_numpy(port_params(arch))
    flat_ref = jax.tree.leaves(ref_params(arch))
    flat_back = jax.tree.leaves(back)
    assert len(flat_ref) == len(flat_back)
    for a, b in zip(flat_ref, flat_back):
        np.testing.assert_array_equal(a, b)
    _, _, _, _, ref_cache = _ref_prefilled(arch)
    _close_cache(cache_from_numpy(jax.tree.map(np.asarray, ref_cache),
                                  device="cpu"), ref_cache)
