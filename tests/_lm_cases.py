"""Shared inputs of the LM parity tests (``test_torch_models.py``,
``test_torch_models_decode.py``, ``test_torch_train*.py``): the
reference's parameters of each smoke config, drawn once from
``jax.random.PRNGKey(0)`` and carried to the port with
``params_from_numpy``, a batch made with numpy from a seed, as
``tests/test_models_smoke.py`` shapes it, and the reference's train
step on it (its gradients, parameters and metrics), once an arch."""

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


def train_batch(cfg, seed=1, B=B, S=S):
    """A numpy train batch: the inputs of ``batch`` and ``labels`` (the
    tokens, or drawn ids for an ``embeds_in`` arch), as
    ``tests/test_models_smoke.py`` shapes it."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.embeds_in and cfg.family != "encdec":
        out["embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.1
                         ).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    out["labels"] = out.get("tokens", rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    if cfg.mrope_sections:
        out["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, None], (3, B, S)).copy()
    if cfg.family == "encdec":
        out["enc_embeds"] = (rng.standard_normal(
            (B, cfg.enc_len, cfg.d_model)) * 0.1).astype(np.float32)
    return out


# the train step both packages take from the reference's parameters
LR = dict(peak_lr=1e-3, total_steps=100, warmup_steps=2)
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
# AdamW's first step moves an entry by about lr·sign(g); where |g| is
# below this, float32's rounding of g decides that sign.  An entry whose
# gradient is exactly 0 (an embedding row of an id the batch lacks)
# moves by the weight decay alone and is held like any other.
SMALL_G = 1e-6


def small_g(g, scale=1.0):
    """The entries of ``g`` with 0 < |g| < scale·SMALL_G."""
    a = np.abs(np.asarray(g))
    return (a > 0) & (a < scale * SMALL_G)


@functools.lru_cache(maxsize=None)
def ref_train_step(arch):
    """The reference's step 0 on ``train_batch``: (its gradients, the
    parameters after its ``make_train_step`` (remat off), its metrics as
    floats), the trees as numpy.  Both come out of one ``jax.jit``, as
    the reference's launcher compiles its step."""
    import jax.numpy as jnp
    from repro.models import forward_train
    from repro.optim.schedules import make_schedule
    from repro.train.step import (
        TrainState,
        cross_entropy,
        make_train_step,
    )
    from repro.optim.adamw import adamw_init

    cfg = get_smoke_config(arch)
    b = {k: jnp.asarray(v) for k, v in train_batch(cfg).items()}
    step = make_train_step(cfg, schedule=make_schedule("cosine", **LR),
                           remat=False)

    def loss(p):
        logits, aux = forward_train(cfg, p, b, remat=False)
        return cross_entropy(logits, b["labels"], cfg.vocab_size) + \
            0.01 * aux

    @jax.jit
    def grads_and_step(params):
        state = TrainState(params, adamw_init(params),
                           jnp.zeros((), jnp.int32))
        return jax.grad(loss)(params), step(state, b)

    grads, (new, metrics) = grads_and_step(
        jax.tree.map(jnp.asarray, ref_params(arch)))
    return (jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, new.params),
            {k: float(v) for k, v in metrics.items()})
