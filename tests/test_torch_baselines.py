"""The paper's §5 baselines, CoCoA and AsySCD, against the reference.

``cocoa_solve`` (one launch of B2 over K partitions a round; its plain
version here) and ``asyscd_solve`` (torch ops) are held to
``repro.core``'s on ``tiny`` over a few rounds or epochs at atol 1e-5 on
α and w, the gaps at 1e-5 + 1e-6·M, with the draws bit-equal through
``repro_torch.prng`` (the partition, each round's local orders, each
epoch's permutation).  The port's twins of ``tests/test_baselines.py``
follow: both baselines converge, and PASSCoDe beats each per epoch.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import asyscd_solve as ref_asyscd
from repro.core import cocoa_solve as ref_cocoa
from repro.core import duals as rd
from repro.data import make_dataset
from repro_torch import prng
from repro_torch.convert import dense_from_numpy
from repro_torch.core import asyscd_solve, cocoa_solve, passcode_solve
from repro_torch.core import duals as td
from repro_torch.data.sparse import dense_to_ell

from test_torch_solver import ATOL, _gap_atol

LOSSES = ("hinge", "squared_hinge", "logistic")


@pytest.fixture(scope="module")
def dense():
    return np.array(make_dataset("tiny").dense_train())


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("K,H,rounds", [(4, None, 4), (3, 100, 3),
                                        (8, 45, 2)],
                         ids=["one_local_epoch", "cycled", "k8"])
@pytest.mark.parametrize("loss", LOSSES)
def test_cocoa_solve_matches_reference(dense, loss, K, H, rounds):
    r = ref_cocoa(dense, rd.make_loss(loss), n_partitions=K,
                  outer_rounds=rounds, local_steps=H, seed=2)
    Xp = dense_from_numpy(dense, device="cpu")
    p = cocoa_solve(Xp, td.make_loss(loss), n_partitions=K,
                    outer_rounds=rounds, local_steps=H, seed=2,
                    device="cpu")
    _close(p.alpha, r.alpha)
    _close(p.w, r.w)
    np.testing.assert_allclose(p.gaps.numpy(), np.asarray(r.gaps), rtol=0,
                               atol=_gap_atol(Xp, p.alpha, td.make_loss(loss)))
    assert p.rounds == r.rounds


@pytest.mark.parametrize("threads,epochs", [(4, 3), (8, 2), (3, 2)])
@pytest.mark.parametrize("loss", LOSSES)
def test_asyscd_solve_matches_reference(dense, loss, threads, epochs):
    r = ref_asyscd(dense, rd.make_loss(loss), n_threads=threads,
                   epochs=epochs, seed=1)
    Xp = dense_from_numpy(dense, device="cpu")
    p = asyscd_solve(Xp, td.make_loss(loss), n_threads=threads,
                     epochs=epochs, seed=1, device="cpu")
    _close(p.alpha, r.alpha)
    np.testing.assert_allclose(p.gaps.numpy(), np.asarray(r.gaps), rtol=0,
                               atol=_gap_atol(Xp, p.alpha, td.make_loss(loss)))
    assert p.epochs == r.epochs


def test_baseline_draws_are_the_reference_key_chain():
    """The partition, a round's K local orders and an epoch's
    permutation, drawn through ``repro_torch.prng``, equal
    ``jax.random``'s bit for bit."""
    n, K = 256, 4
    key, kpart = jax.random.split(jax.random.PRNGKey(2))
    tkey, tpart = prng.split(prng.PRNGKey(2))
    np.testing.assert_array_equal(
        prng.permutation(tpart, n).numpy(),
        np.asarray(jax.random.permutation(kpart, n)))
    _, sub = jax.random.split(key)
    _, tsub = prng.split(tkey)
    want = np.stack([np.asarray(jax.random.permutation(k, n // K))
                     for k in jax.random.split(sub, K)])
    np.testing.assert_array_equal(
        prng.permutation(prng.split(tsub, K), n // K).numpy(), want)


def test_baselines_take_a_dense_x(dense):
    X = dense_to_ell(dense[:20], device="cpu")
    for fn in (cocoa_solve, asyscd_solve):
        with pytest.raises(TypeError, match="dense"):
            fn(X, td.Hinge(), device="cpu")


# ------------------------------- the port's twins of test_baselines.py


def test_cocoa_converges(dense):
    r = cocoa_solve(torch.from_numpy(dense), td.Hinge(), n_partitions=4,
                    outer_rounds=15, device="cpu")
    gaps = r.gaps.numpy()
    assert gaps[-1] < gaps[0] * 0.5, gaps


def test_asyscd_converges(dense):
    r = asyscd_solve(torch.from_numpy(dense), td.Hinge(), n_threads=8,
                     epochs=15, device="cpu")
    gaps = r.gaps.numpy()
    assert gaps[-1] < gaps[0] * 0.7, gaps


def test_passcode_beats_cocoa_per_epoch(dense):
    """Paper §5.1: PASSCoDe converges faster per epoch than CoCoA
    (β_K = 1 averaging shrinks CoCoA's step)."""
    X = torch.from_numpy(dense)
    pc = passcode_solve(X, td.Hinge(), n_threads=4, memory_model="atomic",
                        epochs=10, device="cpu")
    co = cocoa_solve(X, td.Hinge(), n_partitions=4, outer_rounds=10,
                     device="cpu")
    assert float(pc.gaps[-1]) < float(co.gaps[-1]), (pc.gaps[-1],
                                                     co.gaps[-1])


def test_passcode_beats_asyscd_per_epoch(dense):
    """Paper §5: exact coordinate solves (DCD) dominate fixed-step
    projected gradient (AsySCD) per epoch."""
    X = torch.from_numpy(dense)
    pc = passcode_solve(X, td.Hinge(), n_threads=4, memory_model="atomic",
                        epochs=10, device="cpu")
    asy = asyscd_solve(X, td.Hinge(), n_threads=4, epochs=10, device="cpu")
    assert float(pc.gaps[-1]) < float(asy.gaps[-1])
