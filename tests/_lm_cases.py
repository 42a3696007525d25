"""Shared inputs of the LM parity tests (``test_torch_models.py``,
``test_torch_models_decode.py``): the reference's parameters of each
smoke config, drawn once from ``jax.random.PRNGKey(0)`` and carried to
the port with ``params_from_numpy``, and a batch made with numpy from a
seed, as ``tests/test_models_smoke.py`` shapes it."""

import functools

import jax
import numpy as np

from repro.configs import get_smoke_config
from repro.models import init_params as ref_init_params
from repro_torch.convert import params_from_numpy
from repro_torch.configs import get_smoke_config as port_smoke_config

# float32 on both sides; sums over d_model and the vocabulary taken in
# other orders stay well inside 1e-4 at the smoke widths
RTOL = ATOL = 1e-4
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    cfg = get_smoke_config(arch)
    return jax.tree.map(np.asarray, ref_init_params(cfg,
                                                    jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return params_from_numpy(port_smoke_config(arch), ref_params(arch),
                             device="cpu")


def batch(cfg, seed=1, extra=0):
    """A numpy batch of B rows of S + ``extra`` positions."""
    rng = np.random.default_rng(seed)
    n = S + extra
    out = {}
    if cfg.embeds_in and cfg.family != "encdec":
        out["embeds"] = (rng.standard_normal((B, n, cfg.d_model)) * 0.1
                         ).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, n)).astype(
            np.int32)
    if cfg.mrope_sections:
        out["positions"] = np.broadcast_to(
            np.arange(n, dtype=np.int32)[None, None], (3, B, n)).copy()
    if cfg.family == "encdec":
        out["enc_embeds"] = (rng.standard_normal(
            (B, cfg.enc_len, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port.detach().cpu()
                                          if hasattr(port, "detach")
                                          else port),
                               np.asarray(ref), rtol=rtol, atol=atol)
