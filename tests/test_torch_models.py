"""The port's LM stack against the reference's on every smoke config:
``forward_train`` logits and aux loss (MoE tokens dropped and not),
``lm_features``, and the MoE MLP case by case — scatter and einsum
dispatch, a group that drops tokens, tied router scores.  Both packages
run the reference's parameters (``_lm_cases``) in float32, held at
rtol/atol 1e-4 (``_lm_cases.RTOL``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_smoke_config
from repro.models import forward_train as ref_forward
from repro.models import lm_features as ref_features
from repro.models import moe as ref_moe
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.models import forward_train, lm_features
from repro_torch.models import moe as port_moe

from _lm_cases import batch, close, port_params, ref_params


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("no_drop", [False, True], ids=["drop", "no_drop"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch, no_drop):
    cfg = get_smoke_config(arch)
    b = batch(cfg)
    want, want_aux = ref_forward(cfg, ref_params(arch),
                                 {k: jnp.asarray(v) for k, v in b.items()},
                                 remat=False, moe_no_drop=no_drop)
    got, aux = forward_train(port_smoke_config(arch), port_params(arch),
                             _torch_batch(b), moe_no_drop=no_drop)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    close(got, want)
    close(aux, want_aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_features_match_reference(arch):
    cfg = get_smoke_config(arch)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 12))
    pcfg = port_smoke_config(arch)
    if cfg.family == "encdec":
        with pytest.raises(ValueError, match="encdec"):
            ref_features(cfg, ref_params(arch), tokens)
        with pytest.raises(ValueError, match="encdec"):
            lm_features(pcfg, port_params(arch), torch.from_numpy(tokens))
        return
    if cfg.mrope_sections:
        # M-RoPE needs (3, B, S) positions, which lm_features does not
        # take: the reference's assertion fails (ROADMAP C.14) and the
        # port raises where it does
        with pytest.raises(AssertionError):
            ref_features(cfg, ref_params(arch), tokens)
        with pytest.raises(ValueError, match="M-RoPE"):
            lm_features(pcfg, port_params(arch), torch.from_numpy(tokens))
        return
    want = ref_features(cfg, ref_params(arch), tokens)
    got = lm_features(pcfg, port_params(arch), torch.from_numpy(tokens))
    assert got.shape == (3, cfg.d_model)
    close(got, want)


def _moe_inputs(T, D, E, F, seed, tie=False):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, D)) * 0.5).astype(np.float32)
    router = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    if tie:
        # equal logits for experts 1 and 2 (and 0 and 3): every token's
        # top-2 is decided by the index order alone
        router[:, 2] = router[:, 1]
        router[:, 3] = router[:, 0]
    ws = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    return x, router, ws


# (name, T, D, E, F, top_k, capacity_factor, group_size, dispatch, tie)
MOE_CASES = [
    ("scatter", 32, 16, 4, 24, 2, 1.25, 32, "scatter", False),
    ("einsum", 32, 16, 4, 24, 2, 1.25, 32, "einsum", False),
    ("scatter_groups", 48, 16, 4, 24, 2, 1.25, 16, "scatter", False),
    ("drops_tokens", 32, 16, 8, 24, 2, 0.25, 32, "scatter", False),
    ("drops_tokens_einsum", 32, 16, 8, 24, 2, 0.25, 32, "einsum", False),
    ("tied_scores", 16, 16, 4, 24, 2, 1.0, 16, "scatter", True),
    ("tied_scores_einsum", 16, 16, 4, 24, 2, 1.0, 16, "einsum", True),
]


@pytest.mark.parametrize("no_drop", [False, True], ids=["drop", "no_drop"])
@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_mlp_matches_reference(case, no_drop):
    _, T, D, E, F, k, cf, g, dispatch, tie = case
    x, router, ws = _moe_inputs(T, D, E, F, seed=T + E, tie=tie)
    kw = dict(top_k=k, capacity_factor=cf, group_size=g, no_drop=no_drop,
              dispatch=dispatch)
    want, want_aux = ref_moe.moe_mlp(jnp.asarray(x), jnp.asarray(router),
                                     *map(jnp.asarray, ws),
                                     remat_groups=False, **kw)
    got, aux = port_moe.moe_mlp(torch.from_numpy(x),
                                torch.from_numpy(router),
                                *map(torch.from_numpy, ws), **kw)
    close(got, want)
    close(aux, want_aux)


def test_moe_capacity_drops_where_the_reference_does():
    """At capacity factor 0.25 some (token, choice) pairs are dropped:
    the port keeps exactly the pairs the reference keeps, and the tied
    router picks the lower expert index first."""
    x, router, _ = _moe_inputs(32, 16, 8, 24, seed=40)
    C = min(int(max(1, (32 * 2 / 8) * 0.25)), 32)
    want = ref_moe._route(jnp.asarray(x), jnp.asarray(router), 2, C, 8,
                          False)
    got = port_moe._route(torch.from_numpy(x), torch.from_numpy(router), 2,
                          C, 8)
    assert not bool(np.asarray(want[3]).all())  # some pairs dropped
    for g_, w_ in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    xt, rt, _ = _moe_inputs(16, 16, 4, 24, seed=1, tie=True)
    want = ref_moe._route(jnp.asarray(xt), jnp.asarray(rt), 2, 8, 4, False)
    got = port_moe._route(torch.from_numpy(xt), torch.from_numpy(rt), 2, 8,
                          4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "phi3.5-moe-42b-a6.6b",
                                  "jamba-1.5-large-398b"])
def test_forward_train_einsum_dispatch(arch):
    """The smoke configs dispatch by scatter; the full phi3.5 and jamba
    configs by einsum — here forced on the smoke widths."""
    cfg = dataclasses.replace(get_smoke_config(arch), moe_dispatch="einsum")
    pcfg = dataclasses.replace(port_smoke_config(arch),
                               moe_dispatch="einsum")
    b = batch(cfg, seed=3)
    want, want_aux = ref_forward(cfg, ref_params(arch),
                                 {k: jnp.asarray(v) for k, v in b.items()},
                                 remat=False)
    got, aux = forward_train(pcfg, port_params(arch), _torch_batch(b))
    close(got, want)
    close(aux, want_aux)
