"""The per-arch train-step check both train test files run: one step of
the port from the reference's parameters, held to the reference's
gradients, metrics and updated parameters (``_lm_cases``)."""

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import forward_train
from repro_torch.optim import make_schedule
from repro_torch.train import cross_entropy, make_train_step, train_state_for
from repro_torch.tree import leaves, tree_map

from _lm_cases import (
    GRAD_ATOL,
    GRAD_RTOL,
    LR,
    SMALL_G,
    ref_params,
    ref_train_step,
    small_g,
    train_batch,
)


def torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def port_grads(arch, remat=True):
    """The port's gradients of the step's loss, in the reference's
    stacked layout (numpy)."""
    cfg = port_smoke_config(arch)
    params = params_from_numpy(cfg, ref_params(arch), device="cpu")
    aliases = tree_map(lambda p: p.detach().requires_grad_(), params)
    b = torch_batch(train_batch(get_smoke_config(arch)))
    logits, aux = forward_train(cfg, aliases, b, remat=remat)
    loss = cross_entropy(logits, b["labels"], cfg.vocab_size) + 0.01 * aux
    g = torch.autograd.grad(loss, leaves(aliases), allow_unused=True,
                            materialize_grads=True)
    it = iter(g)
    return params_to_numpy(tree_map(lambda _: next(it), params))


def check_train_step(arch):
    """One train step of ``arch``'s smoke config against the reference:
    gradients at rtol 1e-3 / atol 1e-5 (remat on, the port's default),
    the metrics at 1e-5, the updated parameters at atol 1e-5 but where
    0 < |g_ref| < 1e-6 (an entry with no gradient moves by the weight
    decay alone, which both packages take exactly).  Returns (the gradients' worst excess over the
    tolerance, the count of small-g entries)."""
    import jax

    g_ref, p_ref, m_ref = ref_train_step(arch)
    g_port = port_grads(arch)
    worst = -np.inf
    for gp, gr in zip(jax.tree.leaves(g_port), jax.tree.leaves(g_ref)):
        worst = max(worst, float(np.max(np.abs(gp - gr) - GRAD_RTOL
                                        * np.abs(gr))))
        np.testing.assert_allclose(gp, gr, rtol=GRAD_RTOL, atol=GRAD_ATOL)

    cfg = port_smoke_config(arch)
    state = train_state_for(params_from_numpy(cfg, ref_params(arch),
                                              device="cpu"))
    step = make_train_step(cfg, schedule=make_schedule("cosine", **LR))
    new, metrics = step(state, torch_batch(train_batch(
        get_smoke_config(arch))))
    assert int(new.step) == 1 and int(new.opt.count) == 1
    for k in ("loss", "aux", "lr", "grad_norm"):
        assert metrics[k].dim() == 0
        assert float(metrics[k]) == pytest.approx(m_ref[k], rel=1e-5,
                                                  abs=1e-5), k
    small = zero = 0
    for pp, pr, gr in zip(jax.tree.leaves(params_to_numpy(new.params)),
                          jax.tree.leaves(p_ref), jax.tree.leaves(g_ref)):
        ok = ~small_g(gr)
        small += int(np.sum(~ok))
        zero += int(np.sum(gr == 0))
        np.testing.assert_allclose(pp[ok], pr[ok], rtol=0, atol=1e-5)
    print(f"{arch}: gradient worst |Δ| − 1e-3·|g| = {worst:.3g}; "
          f"{small} entries with 0 < |g_ref| < {SMALL_G} left unchecked, "
          f"{zero} with g_ref = 0 checked")
    return worst, small
