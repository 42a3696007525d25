"""The 2-D (feature-sharded) layer of the port against the reference on
the same inputs: ``ell_column_split`` (bit-equal), B4's and B5's plain
versions against the Pallas kernels in interpret mode shard by shard
(the reference's per-shard partials summed with numpy where it would
psum over ``model``), the fused block against the unfused engine and
the reference's 1-D ELL block, the webspam-scale column draw, and the
2-D converters.  atol 1e-5 on α, w, base and Gram: float32, sums taken
in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import duals as rd
from repro.core import sharded as rs
from repro.data import make_dataset
from repro.data.sparse import ell_column_split as ref_split
from repro.kernels import dcd_feature as rfeat
from repro_torch.convert import (
    ell_from_numpy,
    feature_sharded_from_numpy,
    w2d_from_numpy,
    w2d_to_numpy,
)
from repro_torch.core import duals as td
from repro_torch.core import sharded as ts
from repro_torch.data import synthetic
from repro_torch.data.sparse import ell_column_split
from repro_torch.kernels import dcd_feature as feat
from repro_torch.kernels import ops

LOSSES = ["hinge", "squared_hinge", "logistic"]
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref):
    np.testing.assert_allclose(port.cpu().numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.fixture(scope="module")
def tiny():
    X = make_dataset("tiny").X_train
    return X, ell_from_numpy(np.asarray(X.indices), np.asarray(X.values),
                             X.n_features, device="cpu")


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("k_loc", [None, 24])
def test_column_split_bit_equal_and_round_trips(tiny, m, k_loc):
    X, Xp = tiny
    ref = ref_split(X, m, k_loc)
    port = ell_column_split(Xp, m, k_loc, chunk_elems=300)  # 18-row chunks
    assert (port.d_loc, port.k_loc, port.n_shards) == (ref.d_loc, ref.k_loc,
                                                       m)
    np.testing.assert_array_equal(port.indices.numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_array_equal(port.values.numpy().view(np.int32),
                                  np.asarray(ref.values).view(np.int32))
    back = port.to_ell()
    np.testing.assert_array_equal(back.indices.numpy(),
                                  np.asarray(ref.to_ell().indices))
    torch.testing.assert_close(back.to_dense(), Xp.to_dense(), rtol=0,
                               atol=0)
    _close(port.row_sq_norms(chunk_elems=100), ref.row_sq_norms())
    if k_loc is None:
        with pytest.raises(ValueError, match="k_loc"):
            ell_column_split(Xp, m, port.k_loc - 1)


def _block_case(X, m, seed):
    """The reference's split of ``X`` into m shards, primal slices with
    zero dummy slots, feasible α, a mask, ±1 labels and a block of ids
    with a repeat."""
    fse = ref_split(X, m)
    rng = np.random.default_rng(seed)
    n, d1 = X.n_rows, fse.d_loc + 1
    w = (rng.standard_normal((m, d1)) * 0.05).astype(np.float32)
    w[:, -1] = 0.0
    alpha = rng.uniform(0.05, 0.5, n).astype(np.float32)
    active = (rng.random(n) > 0.25).astype(np.float32)
    y = np.where(rng.random(n) > 0.5, 1.0, -1.0).astype(np.float32)
    idx = rng.permutation(n)[:16].astype(np.int32)
    idx[9] = idx[3]  # a repeated id reads its own earlier update
    return fse, w, alpha, active, y, idx


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("loss", LOSSES)
def test_b4_b5_plain_match_pallas_per_shard(tiny, m, loss):
    X, _ = tiny
    fse, w, alpha, active, y, idx = _block_case(X, m, seed=m)
    cols, vals = np.asarray(fse.indices), np.asarray(fse.values)
    q = np.asarray(fse.row_sq_norms())
    parts = [rfeat.dcd_feature_gram_pallas_call(
        jnp.asarray(cols[:, j]), jnp.asarray(vals[:, j]), jnp.asarray(w[j]),
        jnp.asarray(idx), interpret=True) for j in range(m)]
    base_p, gram_p = feat.dcd_feature_gram(_t(cols), _t(vals), _t(w),
                                           _t(idx))
    _close(base_p, np.stack([np.asarray(b) for b, _ in parts]))
    _close(gram_p, np.stack([np.asarray(g) for _, g in parts]))
    base = np.sum([np.asarray(b) for b, _ in parts], axis=0)  # the psum
    gram = np.sum([np.asarray(g) for _, g in parts], axis=0)
    lf_r, lf_p = rd.make_loss(loss, 0.8), td.make_loss(loss, 0.8)
    pa, pw = feat.dcd_feature_update(
        _t(cols), _t(vals), _t(alpha), _t(q), _t(w), _t(idx), _t(base),
        _t(gram), loss=lf_p, active=_t(active), y=_t(y))
    for j in range(m):
        ra, rw = rfeat.dcd_feature_update_pallas_call(
            jnp.asarray(cols[:, j]), jnp.asarray(vals[:, j]),
            jnp.asarray(alpha), jnp.asarray(q), jnp.asarray(w[j]),
            jnp.asarray(idx), jnp.asarray(base), jnp.asarray(gram),
            loss=lf_r, interpret=True, active=jnp.asarray(active),
            y=jnp.asarray(y))
        _close(pa, ra)
        _close(pw[j], rw)
    assert bool((pw[:, -1] == 0.0).all())  # the dummy slots stay 0
    frozen = np.setdiff1d(np.arange(X.n_rows), idx[active[idx] > 0])
    np.testing.assert_array_equal(pa.numpy()[frozen], alpha[frozen])


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("loss", LOSSES)
def test_fused_block_matches_unfused_and_reference_1d(tiny, m, loss):
    """B4 → sum → B5, the unfused per-update engine and the reference's
    1-D ELL block run the same update sequence."""
    X, Xp = tiny
    fse, w_s, alpha, _, _, idx = _block_case(X, m, seed=10 + m)
    d, d_loc = X.n_features, fse.d_loc
    w_s[:, :d_loc].reshape(-1)[d:] = 0.0  # features past d do not exist
    w_1d = np.concatenate([w_s[:, :d_loc].reshape(-1)[:d], [0.0]])
    cols, vals = _t(np.asarray(fse.indices)), _t(np.asarray(fse.values))
    q = _t(np.asarray(fse.row_sq_norms()))
    lf = td.make_loss(loss, 0.8)
    fa, fdw = ops.dcd_feature_block_update(cols, vals, q, _t(alpha),
                                           _t(w_s), _t(idx), loss=lf)
    ua, udw = ts._local_block_update_feature(cols, vals, q, _t(alpha),
                                             _t(w_s), _t(idx), lf)
    ra, rdw = rs._local_block_update_ell(
        jnp.asarray(X.indices), jnp.asarray(X.values), X.row_sq_norms(),
        jnp.asarray(alpha), jnp.asarray(w_1d, jnp.float32),
        jnp.asarray(idx), rd.make_loss(loss, 0.8))
    for a, dw in [(fa, fdw), (ua, udw)]:
        _close(a, ra)
        _close(dw[:, :d_loc].reshape(-1)[:d], np.asarray(rdw)[:d])
        assert bool((dw[:, -1] == 0.0).all())


def test_base_correction_matches_gather_dot(tiny):
    X, Xp = tiny
    fse = ell_column_split(Xp, 2)
    rng = np.random.default_rng(4)
    dvec = _t((rng.standard_normal((2, fse.d_loc + 1)) * 0.1).astype(
        np.float32))
    dvec[:, -1] = 0.0
    idx = _t(np.array([4, 200, 4, 17], np.int32))
    got = ops.dcd_feature_base_correction(fse.indices, fse.values, dvec, idx)
    flat = dvec[:, :fse.d_loc].reshape(-1)[:X.n_features]
    want = Xp.to_dense()[idx.long()] @ flat
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_cpu_wrappers_do_not_launch_and_block_limit(tiny):
    _, Xp = tiny
    fse = ell_column_split(Xp, 2)
    w = torch.zeros((2, fse.d_loc + 1))
    idx = torch.arange(8, dtype=torch.int32)
    before = (feat.dcd_feature_gram.launches,
              feat.dcd_feature_update.launches)
    ops.dcd_feature_block_update(fse.indices, fse.values,
                                 fse.row_sq_norms(), torch.zeros(256), w,
                                 idx, loss=td.Hinge())
    assert (feat.dcd_feature_gram.launches,
            feat.dcd_feature_update.launches) == before
    # past 1,024 ids the block takes the kernels' rows layout; only an
    # empty block is refused
    feat._check_block(fse.indices, fse.values, w,
                      torch.zeros(1025, dtype=torch.int32))
    with pytest.raises(ValueError, match="at least one id"):
        feat._check_block(fse.indices, fse.values, w,
                          torch.zeros(0, dtype=torch.int32))


def test_webspam_stream_draw_law(monkeypatch):
    """The draw for d above ``RACE_MAX_D`` (webspam), exercised at a
    small d: k distinct zipf-skewed columns per row, unit-norm folded
    rows, labels that follow the margin, reproducible from the seed."""
    monkeypatch.setattr(synthetic, "RACE_MAX_D", 100)
    recipe = synthetic.DatasetRecipe("s", 3000, 0, 300, 40, 1.0)
    X, w_true = synthetic.make_paper_split("webspam", seed=2, device="cpu",
                                           recipe=recipe, chunk_elems=4000)
    assert X.indices.shape == (3000, 40) and X.indices.dtype == torch.int32
    srt = X.indices.sort(dim=1).values
    assert bool((srt.diff(dim=1) > 0).all())  # no repeated column
    counts = torch.bincount(X.indices.reshape(-1).long(), minlength=300)
    assert counts[:10].sum() > counts[-10:].sum() * 3  # zipf skew
    torch.testing.assert_close(X.values.norm(dim=1), torch.ones(3000))
    margins = torch.sum(w_true[X.indices.long()] * X.values, dim=1)
    assert float((margins > 0).float().mean()) > 0.75
    again, _ = synthetic.make_paper_split("webspam", seed=2, device="cpu",
                                          recipe=recipe, chunk_elems=4000)
    assert torch.equal(again.indices, X.indices)
    r = synthetic.PAPER_RECIPES["webspam"]
    assert (r.n_train, r.d, r.nnz_per_row, r.C) == (280_000, 16_609_143,
                                                     3_728, 1.0)


def test_2d_converters_carry_the_reference_layout(tiny):
    """The reference's split and its flat 2-D primal (lane-padded slices
    when fused) carry over, and back."""
    X, _ = tiny
    fse = ref_split(X, 3)
    port = feature_sharded_from_numpy(fse.indices, fse.values, X.n_features,
                                      fse.d_loc, device="cpu")
    assert port.k_loc == fse.k_loc and port.n_features == X.n_features
    rng = np.random.default_rng(0)
    d1_ref = 128  # a lane-padded slice of the reference's fused path
    flat = np.zeros((3, d1_ref), np.float32)
    flat[:, :fse.d_loc] = rng.standard_normal((3, fse.d_loc))
    w = w2d_from_numpy(flat.reshape(-1), 3, fse.d_loc, device="cpu")
    assert tuple(w.shape) == (3, fse.d_loc + 1)
    np.testing.assert_array_equal(w2d_to_numpy(w, d1_ref), flat.reshape(-1))
    with pytest.raises(ValueError):
        w2d_from_numpy(np.zeros(3 * fse.d_loc), 3, fse.d_loc, device="cpu")
