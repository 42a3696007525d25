"""The port's LM train step against the reference on the CPU (second
half of the smoke archs; the first in ``test_torch_train.py``), and a
compressed step of each codec against the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS, get_smoke_config
from repro.optim.schedules import make_schedule as ref_schedule
from repro.train.step import init_train_state as ref_init
from repro.train.step import make_train_step as ref_make_step
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.convert import params_from_numpy, train_state_to_numpy
from repro_torch.optim import make_schedule
from repro_torch.train import make_train_step, train_state_for

from _lm_cases import LR, ref_params, small_g, train_batch
from _train_cases import check_train_step, torch_batch

ARCHS_HERE = ARCHS[5:]


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_train_step_matches_reference(arch):
    check_train_step(arch)


# both codecs on a dense model, and top-k on the hybrid, whose periods'
# layer groups are each one tensor of the reference's with one threshold
@pytest.mark.parametrize("arch,codec", [
    ("minicpm-2b", "int8"), ("minicpm-2b", "topk"),
    ("jamba-1.5-large-398b", "topk")])
def test_compressed_step_matches_reference(arch, codec):
    """A step with error-feedback compression before AdamW: metrics at
    1e-5, the residual at atol 1e-5 (at most two int8 entries a rounding
    level apart), parameters at atol 1e-5 (those entries and the small-g
    entries left out)."""
    rcfg, cfg = get_smoke_config(arch), port_smoke_config(arch)
    b = train_batch(rcfg)
    rstate = ref_init(rcfg, jax.random.PRNGKey(0), compress=True)._replace(
        params=jax.tree.map(jnp.asarray, ref_params(arch)))
    rstep = jax.jit(ref_make_step(rcfg, schedule=ref_schedule("cosine",
                                                              **LR),
                                  remat=False, compress_codec=codec))
    state = train_state_for(params_from_numpy(cfg, ref_params(arch),
                                              device="cpu"), compress=True)
    step = make_train_step(cfg, schedule=make_schedule("cosine", **LR),
                           compress_codec=codec)
    rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
    state, m = step(state, torch_batch(b))
    for k in ("loss", "aux", "lr", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(rm[k]), rel=1e-5,
                                            abs=1e-5), k
    mine = train_state_to_numpy(state)
    # where |acc|/scale lies within float32 noise of a .5 boundary, int8
    # rounds the two packages' gradients to neighbouring levels: such an
    # entry's residual differs by one quantum, the group's scale (one
    # entry in 36,864 of mlp/wd with int8; ROADMAP C.16), and so does
    # what it sends, so its parameter is held by that check alone
    flips = 0
    for pp, pr, mr, a, r in zip(
            jax.tree.leaves(mine.params), jax.tree.leaves(rstate.params),
            jax.tree.leaves(rstate.opt.m),
            jax.tree.leaves(mine.compress.residual),
            jax.tree.leaves(rstate.compress.residual)):
        r = np.asarray(r)
        off = np.abs(a - r) > 1e-5
        flips += int(off.sum())
        if codec == "int8" and off.any():
            # a residual lies within half a quantum of 0: the largest
            # over the (stacked) tensor is about half its scale
            quantum = 2 * np.max(np.abs(r))
            np.testing.assert_allclose(np.abs(a - r)[off], quantum,
                                       rtol=0.05)
        else:
            np.testing.assert_allclose(a, r, rtol=0, atol=1e-5)
        ok = ~small_g(mr, 0.1) & ~off
        np.testing.assert_allclose(pp[ok], np.asarray(pr)[ok], rtol=0,
                                   atol=1e-5)
    print(f"{codec}: {flips} residual entries a rounding level apart")
    assert flips <= 2
