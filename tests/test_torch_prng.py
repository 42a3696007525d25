"""``repro_torch.prng`` against ``jax.random`` (threefry2x32,
partitionable mode): keys, splits, random bits and permutations are
bit-equal; the port's block draw is the reference's; and a solve given
only ``seed=`` runs the reference's updates (atol 1e-5 on α and ŵ, the
gap at the tolerance of ``test_torch_solver.py``).
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import dcd_solve as jax_dcd_solve
from repro.core import duals as rd
from repro.core import sharded as rs
from repro.data import make_dataset
from repro_torch import prng
from repro_torch.convert import dense_from_numpy, ell_from_numpy
from repro_torch.core import duals as td
from repro_torch.core import sharded as ts
from repro_torch.core.dcd import dcd_solve

from test_torch_solver import ATOL, _gap_atol

SEEDS = [0, 7, 2**31 - 1]


def _np(key):
    return np.asarray(key).astype(np.int64)  # raw uint32 words


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_bits_bit_equal(seed):
    k, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(kt.numpy(), _np(k))
    for num in (1, 2, 5):
        np.testing.assert_array_equal(prng.split(kt, num).numpy(),
                                      _np(jax.random.split(k, num)))
    sub = jax.random.split(k)[1]
    bits = np.asarray(jax.random.bits(sub, (1000,), np.uint32))
    np.testing.assert_array_equal(
        prng.random_bits(prng.split(kt)[1], 1000).numpy(),
        bits.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 7, 256, 100_000])
def test_permutation_bit_equal(seed, n):
    """n = 10⁵ takes two rounds of the stable sort, n = 1 none."""
    assert prng.shuffle_rounds(n) == (0 if n == 1 else 1 if n < 10**4
                                      else 2)
    k = jax.random.split(jax.random.PRNGKey(seed))[1]
    kt = prng.split(prng.PRNGKey(seed))[1]
    np.testing.assert_array_equal(prng.permutation(kt, n).numpy(),
                                  np.asarray(jax.random.permutation(k, n)))


@pytest.mark.parametrize("p,my,n_loc,n_rows,B", [
    (1, 0, 256, 256, 32),  # p = 1, every row real
    (1, 0, 100, 91, 16),  # a padded tail: 9 invalid ids sort to the back
    (2, 1, 64, 100, 16),  # the second of two shards, 36 real rows
])
def test_device_block_perm_matches_reference(p, my, n_loc, n_rows, B):
    nb = rs._n_blocks(n_loc, B)
    sub = jax.random.split(jax.random.PRNGKey(3))[1]
    ref = rs._device_block_perm(sub, my, p, n_loc, n_rows, nb, B)
    port = ts._device_block_perm(prng.split(prng.PRNGKey(3))[1], my, p,
                                 n_loc, n_rows, nb, B)
    assert port.dtype == torch.int32 and tuple(port.shape) == (nb, B)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def tiny():
    X = make_dataset("tiny").X_train
    return X, np.asarray(X.to_dense())


@pytest.mark.parametrize("ell", [True, False], ids=["ell", "dense"])
@pytest.mark.parametrize("delay_rounds", [0, 1])
def test_seeded_sharded_solve_matches_reference(tiny, ell, delay_rounds):
    X, dense = tiny
    kw = dict(epochs=3, block_size=32, delay_rounds=delay_rounds, seed=11)
    r = rs.sharded_passcode_solve(X if ell else dense, rd.Hinge(), **kw)
    Xp = (ell_from_numpy(np.asarray(X.indices), np.asarray(X.values),
                         X.n_features, device="cpu") if ell
          else dense_from_numpy(dense, device="cpu"))
    p = ts.sharded_passcode_solve(Xp, td.Hinge(), device="cpu", **kw)
    np.testing.assert_allclose(p.alpha.numpy(), np.asarray(r.alpha), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(p.w_hat.numpy(), np.asarray(r.w_hat), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(p.gaps.numpy(), np.asarray(r.gaps), rtol=0,
                               atol=_gap_atol(Xp, p.alpha, td.Hinge()))


@pytest.mark.parametrize("ell", [True, False], ids=["ell", "dense"])
def test_seeded_dcd_solve_matches_reference(tiny, ell):
    X, dense = tiny
    r = jax_dcd_solve(X if ell else dense, rd.Logistic(), epochs=3, seed=6)
    Xp = (ell_from_numpy(np.asarray(X.indices), np.asarray(X.values),
                         X.n_features, device="cpu") if ell
          else dense_from_numpy(dense, device="cpu"))
    p = dcd_solve(Xp, td.Logistic(), epochs=3, seed=6, device="cpu")
    np.testing.assert_allclose(p.alpha.numpy(), np.asarray(r.alpha), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(p.w.numpy(), np.asarray(r.w), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(p.gaps.numpy(), np.asarray(r.gaps), rtol=0,
                               atol=_gap_atol(Xp, p.alpha, td.Logistic()))


def test_seed_out_of_range_raises():
    with pytest.raises(ValueError, match="seed"):
        prng.PRNGKey(-1)
