"""The parent's side of the LM stack's multi-rank tests
(``test_torch_dist_lm*.py``): the reference's inputs written for the
ranks, and the checks of what the ranks return against the reference's
one-device step (``_lm_cases.ref_train_step``) at
``_train_cases.check_train_step``'s tolerances (ROADMAP C.16).

The ranks (``_dist_cases``, kinds ``lm_*``) import no JAX: they read
the reference's smoke parameters and train batch from an ``.npz`` this
module writes (``lm_inputs``)."""

import functools

import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro_torch.tree import leaves_with_names

from _dist_cases import save_tree
from _lm_cases import (
    ATOL,
    GRAD_ATOL,
    GRAD_RTOL,
    LR,
    RTOL,
    ref_params,
    ref_train_step,
    small_g,
    train_batch,
)

ARCHS = ("minicpm-2b", "mamba2-780m", "granite-moe-3b-a800m")


def lm_inputs(tmp, arch) -> str:
    """The reference's parameters of ``arch``'s smoke config and its
    train batch, as ``tmp/<arch>.npz``."""
    path = tmp / f"{arch}.npz"
    if not path.exists():
        save_tree(path, {"params": ref_params(arch),
                         "batch": train_batch(get_smoke_config(arch))})
    return str(path)


def named(out, prefix) -> dict:
    """The arrays of ``out`` under ``prefix/``, by leaf name."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in out.items() if k.startswith(prefix + "/")}


def ref_named(tree) -> dict:
    return {n: np.asarray(a) for n, a in leaves_with_names(tree)}


@functools.lru_cache(maxsize=None)
def ref_micro_step(arch):
    """The reference's step 0 with ``microbatches = 2`` on the same
    parameters and batch: (its updated parameters, its first moment,
    its metrics)."""
    import jax
    import jax.numpy as jnp
    from repro.optim.schedules import make_schedule
    from repro.train.step import init_train_state, make_train_step

    cfg = get_smoke_config(arch)
    state = init_train_state(cfg, jax.random.PRNGKey(0))._replace(
        params=jax.tree.map(jnp.asarray, ref_params(arch)))
    new, m = jax.jit(make_train_step(
        cfg, schedule=make_schedule("cosine", **LR), microbatches=2,
        remat=False))(state, {k: jnp.asarray(v) for k, v in
                              train_batch(cfg).items()})
    return (jax.tree.map(np.asarray, new.params),
            jax.tree.map(np.asarray, new.opt.m),
            {k: float(v) for k, v in m.items()})


def check_step(out, arch, microbatches=1):
    """A mesh step of ``arch`` against the reference's step 0: the
    gathered gradients (of the whole batch) at rtol 1e-3 / atol 1e-5,
    the metrics at 1e-5, the gathered updated parameters at atol 1e-5
    but where 0 < |g_ref| < 1e-6 (C.16); every leaf updated in place, in
    its own shard.  With ``microbatches = 2`` the metrics and parameters
    are held to the reference's microbatched step, its small-g entries
    read from its first moment (1 − b1)·g, as
    ``test_torch_train.test_microbatches_match_full_batch_and_reference``
    holds the one-process step."""
    g_ref, p_ref, m_ref = ref_train_step(arch)
    g_ref, p_ref = ref_named(g_ref), ref_named(p_ref)
    if microbatches == 1:
        small = {n: small_g(g) for n, g in g_ref.items()}
    else:
        p_ref, mom, m_ref = ref_micro_step(arch)
        p_ref = ref_named(p_ref)
        small = {n: small_g(m, 0.1) for n, m in ref_named(mom).items()}
    g, p = named(out, "g"), named(out, "p")
    assert sorted(g) == sorted(g_ref) == sorted(p) == sorted(p_ref)
    for name, gr in g_ref.items():
        np.testing.assert_allclose(g[name], gr, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
        ok = ~small[name]
        np.testing.assert_allclose(p[name][ok], p_ref[name][ok], rtol=0,
                                   atol=1e-5, err_msg=name)
    for k in ("loss", "aux", "lr", "grad_norm"):
        # every rank's float() of its metric reads the whole value
        for v in out[k]:
            assert float(v) == pytest.approx(m_ref[k], rel=1e-5,
                                             abs=1e-5), k
    assert bool(out["inplace"]) and bool(out["shards"])


def check_codecs(out):
    """Both codecs on the mesh give the one-process bits: the same
    inputs, so top-k's threshold and int8's scale are the one-device
    ones exactly."""
    for codec in ("topk", "int8"):
        for part in ("sent", "residual"):
            one = named(out, f"{codec}/one/{part}")
            mesh = named(out, f"{codec}/mesh/{part}")
            assert sorted(one) == sorted(mesh)
            for name in one:
                np.testing.assert_array_equal(mesh[name], one[name],
                                              err_msg=f"{codec} {name}")
        kept = sum(int(np.count_nonzero(a)) for a in named(
            out, f"{codec}/one/sent").values())
        assert kept > 0


def check_loop(out, world):
    """A fault on rank 0 alone: every rank failed once at step 3,
    restored step 2 and ends on the clean run's bits; the clean run's
    checkpoint, saved across the ranks, restores at one process and
    onto the mesh bit for bit."""
    clean, fault = out["clean/report"], out["fault/report"]
    assert clean.shape[0] == world
    for r in range(world):
        assert clean[r].tolist() == [4, 0, 0]
        assert fault[r].tolist() == [4, 1, 1, 2]
    # every rank read the same losses; the fault run replayed step 2
    clean, fault = out["clean/losses"], out["fault/losses"]
    assert (clean == clean[0]).all() and (fault == fault[0]).all()
    np.testing.assert_array_equal(fault[0], np.concatenate(
        [clean[0][:3], clean[0][2:]]))
    a, b = named(out, "clean/p"), named(out, "fault/p")
    for name in a:
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    saved = named(out, "saved")
    assert int(out["onto_step"]) == 4 and bool(out["onto_shards"])
    for run in ("onto", "alone"):
        got = named(out, run)
        assert sorted(got) == sorted(saved)
        for name in saved:
            np.testing.assert_array_equal(got[name], saved[name],
                                          err_msg=f"{run} {name}")


def check_serve(out):
    """Prefill and greedy decode on the mesh against one process from
    the same parameters: the tokens equal, the logits at
    ``_lm_cases.RTOL``."""
    np.testing.assert_array_equal(out["mesh_tokens"], out["one_tokens"])
    for k in ("prefill", "last"):
        np.testing.assert_allclose(out[f"mesh_{k}"], out[f"one_{k}"],
                                   rtol=RTOL, atol=ATOL)
