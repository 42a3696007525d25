"""The port's CUDA kernels on the card, each held to its plain PyTorch
version on the same inputs, and the solver's kernel path held to its
CPU path.  Every test is marked ``cuda`` and skips without a card.

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed (see the README for the command).  Tolerance atol
1e-5 on α and w: float32, the kernel sums its dot in another order and
scatters with atomics in no fixed order.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import duals as td
from repro_torch.core.sharded import sharded_passcode_solve
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels.dcd_block import (
    dcd_indexed_epoch,
    dcd_indexed_epoch_plain,
    dcd_tile_epoch,
    dcd_tile_epoch_plain,
)
from repro_torch.data.sparse import ell_column_split
from repro_torch.dist.mesh import solver_mesh_2d
from repro_torch.kernels import dcd_feature as feat
from repro_torch.kernels.dcd_ell import dcd_ell_epoch, dcd_ell_epoch_plain

LOSSES = ["hinge", "squared_hinge", "logistic"]
ATOL = 1e-5


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(a, b):
    torch.cuda.synchronize()
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                               atol=ATOL)


def _state(rng, n, w_len, dev):
    alpha = rng.uniform(0.05, 0.5, n).astype(np.float32)
    w = (rng.standard_normal(w_len) * 0.1).astype(np.float32)
    active = (rng.random(n) > 0.25).astype(np.float32)
    y = np.where(rng.random(n) > 0.5, 1.0, -1.0).astype(np.float32)
    idx = np.concatenate([rng.permutation(n)[: n - 7],
                          [3, 3, 0, n - 1, 17]]).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (alpha, w, active, y, idx)]


@pytest.mark.cuda
@pytest.mark.parametrize("loss", LOSSES)
def test_b1_kernel_matches_plain(loss):
    dev = _cuda()
    rng = np.random.default_rng(5)
    n, d, k = 200, 300, 37
    cols = np.full((n, k), d, np.int32)
    vals = np.zeros((n, k), np.float32)
    for i in range(n):
        nnz = rng.integers(1, k + 1)
        cols[i, :nnz] = rng.choice(d, nnz, replace=False)
        vals[i, :nnz] = rng.standard_normal(nnz) * 0.3
    cols[5, 1] = cols[5, 0]  # a repeated column accumulates
    cols, vals = torch.from_numpy(cols).to(dev), torch.from_numpy(vals).to(dev)
    alpha, w, active, y, idx = _state(rng, n, d + 1, dev)
    w[d] = 0.0
    kw = dict(loss=td.make_loss(loss, 0.8), idx=idx, active=active, y=y)
    q = (vals * vals).sum(1)
    n0 = dcd_ell_epoch.launches
    ka, kwv = dcd_ell_epoch(cols, vals, alpha, w, q, **kw)
    assert dcd_ell_epoch.launches == n0 + 1
    pa, pw = dcd_ell_epoch_plain(cols, vals, alpha, w, q, **kw)
    _close(ka, pa)
    _close(kwv, pw)
    assert float(kwv[d]) == 0.0  # the dummy slot stays exactly 0


@pytest.mark.cuda
@pytest.mark.parametrize("loss", LOSSES)
def test_b2_b3_kernels_match_plain(loss):
    dev = _cuda()
    rng = np.random.default_rng(6)
    n, d = 300, 54
    X = torch.from_numpy(
        (rng.standard_normal((n, d)) * 0.2).astype(np.float32)).to(dev)
    alpha, w, active, y, idx = _state(rng, n, d, dev)
    q = (X * X).sum(1)
    lf = td.make_loss(loss, 0.8)
    n0 = (dcd_indexed_epoch.launches, dcd_tile_epoch.launches)
    ka, kw = dcd_indexed_epoch(X, alpha, w, q, loss=lf, idx=idx,
                               active=active, y=y)
    pa, pw = dcd_indexed_epoch_plain(X, alpha, w, q, loss=lf, idx=idx,
                                     active=active, y=y)
    _close(ka, pa)
    _close(kw, pw)
    ka, kw = dcd_tile_epoch(X, alpha, w, q, loss=lf)
    pa, pw = dcd_tile_epoch_plain(X, alpha, w, q, loss=lf)
    _close(ka, pa)
    _close(kw, pw)
    assert (dcd_indexed_epoch.launches, dcd_tile_epoch.launches) == (
        n0[0] + 1, n0[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("ell", [True, False], ids=["ell", "dense"])
def test_solver_kernel_path_matches_cpu_path(ell):
    dev = _cuda()
    ds = make_dataset("tiny", device="cpu")
    X = ds.X_train if ell else ds.dense_train()
    rng = np.random.default_rng(0)
    blocks = np.stack([rng.permutation(256).reshape(8, 32) for _ in range(3)])
    kw = dict(epochs=3, block_size=32, delay_rounds=1, blocks=blocks)
    on_card = sharded_passcode_solve(X.to(dev), td.Hinge(), **kw)
    on_cpu = sharded_passcode_solve(X, td.Hinge(), device="cpu", **kw)
    _close(on_card.alpha, on_cpu.alpha)
    _close(on_card.w_hat, on_cpu.w_hat)
    np.testing.assert_allclose(on_card.gaps.cpu().numpy(),
                               on_cpu.gaps.numpy(), rtol=1e-5, atol=ATOL)
    with pytest.raises(ValueError, match="plain engines"):
        sharded_passcode_solve(X.to(dev), td.Hinge(), use_kernel=False, **kw)


def _feature_case(dev, n=300, m=3, k=40, d_loc=500, b=48, seed=7):
    """Shard-local ELL slices with ragged rows (trailing padding id
    d_loc), a repeated column, primal slices with zero dummy slots, and a
    block with repeated ids."""
    rng = np.random.default_rng(seed)
    cols = np.full((n, m, k), d_loc, np.int32)
    vals = np.zeros((n, m, k), np.float32)
    for i in range(n):
        for j in range(m):
            nnz = rng.integers(0, k + 1)
            cols[i, j, :nnz] = rng.choice(d_loc, nnz, replace=False)
            vals[i, j, :nnz] = rng.standard_normal(nnz) * 0.1
    cols[5, 1, 1] = cols[5, 1, 0]  # a repeated column accumulates
    w = (rng.standard_normal((m, d_loc + 1)) * 0.05).astype(np.float32)
    w[:, d_loc] = 0.0
    idx = rng.permutation(n)[:b].astype(np.int32)
    idx[[7, 20, 21]] = [5, idx[3], 5]
    return [torch.from_numpy(a).to(dev) for a in (cols, vals, w, idx)]


@pytest.mark.cuda
@pytest.mark.parametrize("loss", LOSSES)
def test_b4_b5_kernels_match_plain(loss):
    dev = _cuda()
    cols, vals, w, idx = _feature_case(dev)
    m, d1 = w.shape
    scratch = feat.gram_scratch(m, d1, dev)
    n0 = (feat.dcd_feature_gram.launches, feat.dcd_feature_update.launches)
    kb, kg = feat.dcd_feature_gram(cols, vals, w, idx, scratch=scratch)
    pb, pg = feat.dcd_feature_gram_plain(cols, vals, w, idx)
    _close(kb, pb)
    _close(kg, pg)
    assert float(scratch.abs().max()) == 0.0  # left zeroed
    rng = np.random.default_rng(8)
    n = cols.shape[0]
    alpha, _, active, y, _ = _state(rng, n, 1, dev)
    q = (vals * vals).sum((1, 2))
    kw = dict(loss=td.make_loss(loss, 0.8), active=active, y=y)
    base, gram = pb.sum(0), pg.sum(0)
    ka, kwv = feat.dcd_feature_update(cols, vals, alpha, q, w, idx, base,
                                      gram, **kw)
    pa, pw = feat.dcd_feature_update_plain(cols, vals, alpha, q, w, idx,
                                           base, gram, **kw)
    _close(ka, pa)
    _close(kwv, pw)
    assert float(kwv[:, -1].abs().max()) == 0.0  # dummy slots stay 0
    assert (feat.dcd_feature_gram.launches,
            feat.dcd_feature_update.launches) == (n0[0] + 1, n0[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("delay_rounds", [0, 1])
def test_2d_solver_kernel_path_matches_cpu_path(delay_rounds):
    """The fused engine on the card (with delay 1, the overlapped round)
    against the fused engine's plain versions on the CPU."""
    dev = _cuda()
    X = make_dataset("tiny", device="cpu").X_train
    kw = dict(mesh=solver_mesh_2d(model=2), epochs=3, block_size=32,
              delay_rounds=delay_rounds, seed=4)
    n0 = feat.dcd_feature_update.launches
    on_card = sharded_passcode_solve(X.to(dev), td.Hinge(), **kw)
    assert feat.dcd_feature_update.launches == n0 + 3 * 8
    on_cpu = sharded_passcode_solve(X, td.Hinge(), use_kernel=True,
                                    device="cpu", **kw)
    _close(on_card.alpha, on_cpu.alpha)
    _close(on_card.w_hat, on_cpu.w_hat)
    np.testing.assert_allclose(on_card.gaps.cpu().numpy(),
                               on_cpu.gaps.numpy(), rtol=1e-5, atol=ATOL)
    with pytest.raises(ValueError, match="plain engines"):
        sharded_passcode_solve(X.to(dev), td.Hinge(), use_kernel=False,
                               **kw)


@pytest.mark.cuda
def test_column_split_on_the_card_matches_cpu():
    dev = _cuda()
    X = make_dataset("tiny", device="cpu").X_train
    on_cpu = ell_column_split(X, 3)
    on_card = ell_column_split(X.to(dev), 3, chunk_elems=500)
    assert torch.equal(on_card.indices.cpu(), on_cpu.indices)
    assert torch.equal(on_card.values.cpu(), on_cpu.values)
