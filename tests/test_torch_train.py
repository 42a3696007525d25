"""The port's LM train step against the reference on the CPU (first
half of the smoke archs; the rest in ``test_torch_train_step.py``):
``cross_entropy`` with the padded vocabulary, one step of each arch from
the reference's parameters (``_train_cases.check_train_step``), remat
on against off, and microbatches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_smoke_config
from repro.optim.schedules import make_schedule as ref_schedule
from repro.train.step import cross_entropy as ref_cross_entropy
from repro.train.step import init_train_state as ref_init
from repro.train.step import make_train_step as ref_make_step
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.convert import (
    params_from_numpy,
    params_to_numpy,
    train_state_from_numpy,
)
from repro_torch.optim import make_schedule
from repro_torch.train import cross_entropy, make_train_step, train_state_for
from repro_torch.tree import leaves, tree_map

from _lm_cases import LR, ref_params, small_g, train_batch
from _train_cases import check_train_step, torch_batch

ARCHS_HERE = ARCHS[:5]


def test_cross_entropy_matches_reference_with_padded_vocab():
    """Targets in the padded columns [vocab, Vp) and below 0 are masked;
    the rest is logsumexp minus the picked logit, t + 1 from t."""
    rng = np.random.default_rng(0)
    V, Vp = 500, 512
    logits = (rng.standard_normal((3, 17, Vp)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (3, 17)).astype(np.int32)
    labels[0, 3], labels[1, 5], labels[2, 9] = 505, -1, 511
    want = ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), V)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        V)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    # all targets masked: the sum over no entries over max(0, 1)
    none = np.full((2, 4), V + 1, np.int32)
    assert float(cross_entropy(torch.from_numpy(logits[:2, :4]),
                               torch.from_numpy(none), V)) == 0.0


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_train_step_matches_reference(arch):
    check_train_step(arch)


def _clone(state):
    return tree_map(lambda t: t.clone(), state)


def _bits_equal(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype and torch.equal(
            x.view(torch.int32) if x.dtype == torch.float32 else x,
            y.view(torch.int32) if y.dtype == torch.float32 else y)


# a dense, an SSM, the hybrid (periods), both MoE dispatches, encdec
@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-780m",
                                  "jamba-1.5-large-398b",
                                  "granite-moe-3b-a800m",
                                  "phi3.5-moe-42b-a6.6b", "whisper-small"])
def test_remat_changes_no_bit(arch):
    cfg = port_smoke_config(arch)
    state = train_state_for(params_from_numpy(cfg, ref_params(arch),
                                              device="cpu"))
    b = torch_batch(train_batch(get_smoke_config(arch)))
    sched = make_schedule("cosine", **LR)
    on, m_on = make_train_step(cfg, schedule=sched, remat=True)(
        _clone(state), b)
    off, m_off = make_train_step(cfg, schedule=sched, remat=False)(
        _clone(state), b)
    for k in m_on:
        assert torch.equal(m_on[k], m_off[k]), k
    _bits_equal(on, off)


def test_microbatches_match_full_batch_and_reference():
    """microbatches = 2 against 1 (the reference's own tolerance), and
    against the reference's microbatched step (1e-5; its small-g entries
    left out)."""
    arch = "minitron-4b"
    rcfg, cfg = get_smoke_config(arch), port_smoke_config(arch)
    b = train_batch(rcfg, B=4, S=32)
    sched = make_schedule("cosine", **LR)
    state = train_state_for(params_from_numpy(cfg, ref_params(arch),
                                              device="cpu"))
    s1, m1 = make_train_step(cfg, schedule=sched, microbatches=1)(
        _clone(state), torch_batch(b))
    s2, m2 = make_train_step(cfg, schedule=sched, microbatches=2)(
        _clone(state), torch_batch(b))
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    for a, c in zip(leaves(s1.params), leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-3,
                                   atol=1e-5)

    rstate = ref_init(rcfg, jax.random.PRNGKey(0))._replace(
        params=jax.tree.map(jnp.asarray, ref_params(arch)))
    rnew, rm = jax.jit(ref_make_step(rcfg,
                                     schedule=ref_schedule("cosine", **LR),
                                     microbatches=2, remat=False))(
        rstate, {k: jnp.asarray(v) for k, v in b.items()})
    for k in ("loss", "aux", "lr", "grad_norm"):
        assert float(m2[k]) == pytest.approx(float(rm[k]), rel=1e-5,
                                             abs=1e-5), k
    # the reference's first moment is (1 − b1)·g: its entries with
    # 0 < |m| < (1 − b1)·SMALL_G are the small-g entries
    for pp, pr, mr in zip(jax.tree.leaves(params_to_numpy(s2.params)),
                          jax.tree.leaves(rnew.params),
                          jax.tree.leaves(rnew.opt.m)):
        ok = ~small_g(mr, 0.1)
        np.testing.assert_allclose(pp[ok], np.asarray(pr)[ok], rtol=0,
                                   atol=1e-5)
    # and the port's state converts to the reference's as it is
    back = train_state_from_numpy(cfg, jax.tree.map(np.asarray, rnew),
                                  device="cpu")
    assert int(back.step) == 1 and int(back.opt.count) == 1


def test_microbatches_split_mrope_positions_on_dim_1():
    arch = "qwen2-vl-72b"
    cfg = port_smoke_config(arch)
    b = torch_batch(train_batch(get_smoke_config(arch), B=4))
    state = train_state_for(params_from_numpy(cfg, ref_params(arch),
                                              device="cpu"))
    sched = make_schedule("cosine", **LR)
    _, m1 = make_train_step(cfg, schedule=sched)(_clone(state), b)
    _, m2 = make_train_step(cfg, schedule=sched, microbatches=2)(
        _clone(state), b)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, schedule=sched, microbatches=3)(
            _clone(state), b)
