"""The port's CUDA kernels on the card, each held to its plain PyTorch
version on the same inputs, and the solver's kernel path held to its
CPU path.  Every test is marked ``cuda`` and skips without a card.

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed (see the README for the command).  Tolerance atol
1e-5 on α and w: float32, the kernel sums its dot in another order and
scatters with atomics in no fixed order.
"""

import shutil

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import duals as td
from repro_torch.core.passcode import passcode_epoch, passcode_solve
from repro_torch.core.sharded import (
    sharded_passcode_feature,
    sharded_passcode_solve,
)
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels.dcd_block import (
    dcd_indexed_epoch,
    dcd_indexed_epoch_plain,
    dcd_tile_epoch,
    dcd_tile_epoch_plain,
)
from repro_torch.data.sparse import ell_column_split
from repro_torch.dist.mesh import (
    DENSE_SPLIT_MAX_D,
    DENSE_STAGED_MAX_D,
    GRAM_CHUNK,
    TILE_STREAM_ROWS,
    dcd_dense_plan,
    dcd_ell_plan,
    dcd_tile_plan,
    feature_update_plan,
    gram_plan,
    SolverMesh,
    solver_mesh,
    solver_mesh_2d,
)
from repro_torch.kernels import dcd_feature as feat
from repro_torch.kernels.dcd_ell import dcd_ell_epoch, dcd_ell_epoch_plain
from repro_torch.resilience import FaultPlan, solve_segmented

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


def _ell_case(dev, n, d, k, b, seed=5, repeat_col=True, unit_rows=False):
    """Ragged ELL rows (trailing padding id d) of 0.3·N(0, 1) values, or
    with ``unit_rows`` 0.3·N(0, 1)/√nnz (rows of about 0.3 in norm
    whatever their width), a row that repeats a column (row 5, if
    ``repeat_col``), and a block of ``b`` ids with repeats."""
    rng = np.random.default_rng(seed)
    cols = np.full((n, k), d, np.int32)
    vals = np.zeros((n, k), np.float32)
    for i in range(n):
        nnz = rng.integers(1, k + 1)
        cols[i, :nnz] = rng.choice(d, nnz, replace=False)
        vals[i, :nnz] = rng.standard_normal(nnz) * 0.3
        if unit_rows:
            vals[i, :nnz] /= np.sqrt(nnz)
    if repeat_col:
        cols[5, 1] = cols[5, 0]  # a repeated column accumulates
    alpha, w, active, y, _ = _state(rng, n, d + 1, dev)
    w[d] = 0.0
    idx = rng.permutation(n)[:b].astype(np.int32)
    idx[[1, b - 1]] = [5, idx[0]]  # row 5, and a repeated id
    cols, vals = torch.from_numpy(cols).to(dev), torch.from_numpy(vals).to(dev)
    return cols, vals, alpha, w, active, y, torch.from_numpy(idx).to(dev)


# (n, d, k, b), the variant dcd_ell_plan must pick, and whether the rows
# are scaled to unit width: rows wider than a warp; rows of 128 slots,
# the most the staged kernel's update warp holds; rows wider than 1,024
# slots (scaled, so that their wx and q stay on the narrow rows' scale);
# and a block too large to stage (both now the stream variant's)
ELL_CASES = {"staged": ((200, 300, 37, 198), "staged", False),
             "staged_128_slot_rows": ((200, 3000, 128, 64), "staged", False),
             "wide_1100_slot_rows": ((40, 5000, 1100, 4), "stream", True),
             "wide": ((200, 3000, 400, 64), "stream", False)}


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("case", sorted(ELL_CASES))
@pytest.mark.parametrize("loss", LOSSES)
def test_b1_kernel_matches_plain(loss, case, masked):
    dev = _cuda()
    shape, variant, unit_rows = ELL_CASES[case]
    cols, vals, alpha, w, active, y, idx = _ell_case(dev, *shape,
                                                     unit_rows=unit_rows)
    d = shape[1]
    assert dcd_ell_plan(idx.shape[0], cols.shape[1], d).variant == variant
    kw = dict(loss=td.make_loss(loss, 0.8), idx=idx)
    if masked:
        kw.update(active=active, y=y)
    q = (vals * vals).sum(1)
    n0 = (dcd_ell_epoch.launches, dcd_ell_epoch.variant_launches[variant])
    ka, kwv = dcd_ell_epoch(cols, vals, alpha, w, q, **kw)
    assert (dcd_ell_epoch.launches,
            dcd_ell_epoch.variant_launches[variant]) == (n0[0] + 1, n0[1] + 1)
    pa, pw = dcd_ell_epoch_plain(cols, vals, alpha, w, q, **kw)
    _close(ka, pa)
    _close(kwv, pw)
    assert float(kwv[d]) == 0.0  # the dummy slot stays exactly 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ELL_CASES))
def test_b1_kernel_is_deterministic(case):
    """No row repeats a column: a second launch gives the same bits."""
    dev = _cuda()
    shape, _, unit_rows = ELL_CASES[case]
    cols, vals, alpha, w, active, y, idx = _ell_case(
        dev, *shape, repeat_col=False, unit_rows=unit_rows)
    q = (vals * vals).sum(1)
    kw = dict(loss=td.Hinge(0.8), idx=idx, active=active, y=y)
    first = dcd_ell_epoch(cols, vals, alpha, w, q, **kw)
    second = dcd_ell_epoch(cols, vals, alpha, w, q, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["staged", "staged_128_slot_rows"])
def test_b1_variants_agree(case):
    """The wide variant, asked for at a shape the staged one takes, gives
    the same (α, w) within the tolerance."""
    dev = _cuda()
    shape = ELL_CASES[case][0]
    cols, vals, alpha, w, active, y, idx = _ell_case(dev, *shape)
    q = (vals * vals).sum(1)
    kw = dict(loss=td.Hinge(0.8), idx=idx, active=active, y=y)
    n0 = dict(dcd_ell_epoch.variant_launches)
    sa, sw = dcd_ell_epoch(cols, vals, alpha, w, q, **kw)
    wa, ww = dcd_ell_epoch(cols, vals, alpha, w, q, wide=True, **kw)
    assert dcd_ell_epoch.variant_launches == {
        "staged": n0["staged"] + 1, "stream": n0["stream"],
        "wide": n0["wide"] + 1}
    _close(sa, wa)
    _close(sw, ww)


# B1's stream variant: (n, d, k, b) and whether w goes in shared memory:
# rows of at most 128 slots (one consumer warp) and longer ones (several),
# w beside the ring or in device memory
ELL_STREAM_CASES = {"narrow_w_shared": ((3000, 3000, 37, 2500), True),
                    "narrow_w_device": ((3000, 60_000, 73, 9000), False),
                    "long_rows_w_shared": ((300, 3000, 400, 300), True),
                    "long_rows_w_device": ((200, 300_000, 1100, 200),
                                           False)}


def _stream_ids(n, b, most, seed=7):
    """``b`` ids drawn from [0, n) with row 5 (the row that repeats a
    column) second, and an id recurring at each distance 1, 2, …,
    ``most`` + 1 (the ring's lookahead and one past it), the pairs laid
    end to end from position 3."""
    idx = np.random.default_rng(seed).integers(0, n, b).astype(np.int32)
    idx[1] = 5
    pos = 3
    for dist in range(1, most + 2):
        if pos + dist >= b:
            break
        idx[pos + dist] = idx[pos]
        pos += dist + 1
    return idx


def _stream_case(dev, case, repeat_col=True):
    (n, d, k, b), shared = ELL_STREAM_CASES[case]
    cols, vals, alpha, w, active, y, _ = _ell_case(
        dev, n, d, k, 4, repeat_col=repeat_col, unit_rows=k > 128)
    plan = dcd_ell_plan(b, k, d)
    assert (plan.variant, plan.w_shared) == ("stream", shared)
    idx = torch.from_numpy(_stream_ids(n, b, plan.tile_rows * plan.stages))
    return cols, vals, alpha, w, active, y, idx.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("case", sorted(ELL_STREAM_CASES))
@pytest.mark.parametrize("loss", LOSSES)
def test_b1_stream_matches_plain(loss, case, masked):
    """The stream variant on a block with ids recurring at every distance
    of the ring's lookahead and a row that repeats a column, against the
    plain version (on host copies) and against the wide variant."""
    dev = _cuda()
    cols, vals, alpha, w, active, y, idx = _stream_case(dev, case)
    d = w.shape[0] - 1
    kw = dict(loss=td.make_loss(loss, 0.8), idx=idx)
    if masked:
        kw.update(active=active, y=y)
    q = (vals * vals).sum(1)
    n0 = dict(dcd_ell_epoch.variant_launches)
    ka, kwv = dcd_ell_epoch(cols, vals, alpha, w, q, **kw)
    wa, ww = dcd_ell_epoch(cols, vals, alpha, w, q, wide=True, **kw)
    assert dcd_ell_epoch.variant_launches == {
        "staged": n0["staged"], "stream": n0["stream"] + 1,
        "wide": n0["wide"] + 1}
    host = {key: v.cpu() if torch.is_tensor(v) else v
            for key, v in kw.items()}
    pa, pw = dcd_ell_epoch_plain(cols.cpu(), vals.cpu(), alpha.cpu(),
                                 w.cpu(), q.cpu(), **host)
    _close(ka, pa)
    _close(kwv, pw)
    _close(ka, wa)
    _close(kwv, ww)
    assert float(kwv[d]) == 0.0  # the dummy slot stays exactly 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ELL_STREAM_CASES))
def test_b1_stream_is_deterministic(case):
    """A row that repeats a column scatters in slot order from one
    thread: a second launch gives the same bits."""
    dev = _cuda()
    cols, vals, alpha, w, active, y, idx = _stream_case(dev, case)
    q = (vals * vals).sum(1)
    kw = dict(loss=td.Hinge(0.8), idx=idx, active=active, y=y)
    first = dcd_ell_epoch(cols, vals, alpha, w, q, **kw)
    second = dcd_ell_epoch(cols, vals, alpha, w, q, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# the stream variants' grids: (K tasks, P pods, p shards a pod, n_loc, b
# ids a block, past the staged kernels' 1,024)
STREAM_GRIDS = {"shards": (1, 1, 3, 400, 1100),
                "tasks": (3, 1, 2, 400, 1100),
                "pods": (1, 2, 2, 400, 1100)}


def _grid_operands(rng, grid, width, n, dev):
    """α, the views of w (one for every shard, or one a pod), act and y
    of a stream grid, in the binary layout when K = 1."""
    K, P = STREAM_GRIDS[grid][:2]
    alpha, _, act, y = _task_operands(rng, K, n, (1,), dev, True)
    w = _pod_views(rng, K, P, width, dev)
    w = w if P > 1 else w[:, 0]
    if K == 1:
        alpha, w, y = alpha[0], w[0], y[0]
    return alpha, w, act, y


@pytest.mark.cuda
@pytest.mark.parametrize("w_place", ["shared", "device"])
@pytest.mark.parametrize("grid", sorted(STREAM_GRIDS))
def test_b1_stream_grids_match_plain(grid, w_place):
    """B1's stream variant over the shard, task and pod grids, each
    (task, shard) pair updating its own replica of w (in shared or in
    device memory), against its plain version and the wide variant; a
    second launch gives the same bits."""
    from repro_torch.kernels.dcd_ell import (
        dcd_ell_shards,
        dcd_ell_shards_plain,
    )
    dev = _cuda()
    K, P, p, n_loc, b = STREAM_GRIDS[grid]
    S, d = P * p, 3000 if w_place == "shared" else 60_000
    cols, vals, *_ = _ell_case(dev, n_loc * S, d, 37, 4)
    rng = np.random.default_rng(41)
    alpha, w, act, y = _grid_operands(rng, grid, d + 1, n_loc * S, dev)
    w[..., -1] = 0.0
    ids = _task_ids(rng, K, n_loc, S, b, dev, True)
    q = (vals * vals).sum(1)
    plan = dcd_ell_plan(b, 37, d, False, p, K, P)
    assert plan == dcd_ell_plan(b, 37, d)._replace(shards=p, tasks=K,
                                                   pods=P)
    assert (plan.variant, plan.w_shared) == ("stream", w_place == "shared")
    kw = dict(loss=td.Hinge(0.8), idx=ids, n_loc=n_loc, active=act, y=y)
    n0 = dcd_ell_shards.variant_launches["stream"]
    ka, kdw = dcd_ell_shards(cols, vals, alpha, w, q, **kw)
    assert dcd_ell_shards.variant_launches["stream"] == n0 + 1
    pa, pdw = dcd_ell_shards_plain(cols, vals, alpha, w, q, **kw)
    _close(ka, pa)
    _close(kdw, pdw)
    assert float(kdw[..., -1].abs().max()) == 0.0
    wa, wdw = dcd_ell_shards(cols, vals, alpha, w, q, wide=True, **kw)
    _close(ka, wa)
    _close(kdw, wdw)
    again = dcd_ell_shards(cols, vals, alpha, w, q, **kw)
    torch.cuda.synchronize()
    assert torch.equal(again[0], ka) and torch.equal(again[1], kdw)


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


def _dense_case(dev, n, d, seed=9):
    """Rows of 0.2·N(0, 1)/√(d/54) (covtype's scale whatever d), the
    state of ``_state`` and its block of ids with repeats."""
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) * 0.2 / np.sqrt(d / 54)).astype(
        np.float32)
    alpha, w, active, y, idx = _state(rng, n, d, dev)
    idx = torch.cat([idx[:59], idx[-5:]])  # ends 3, 3, 0, n - 1, 17
    return torch.from_numpy(X).to(dev), alpha, w, active, y, idx


# d of the rows: covtype's 54, the largest d the staged variant takes, one
# past it (split), the largest the split variant takes, one past it (wide)
DENSE_DS = [54, DENSE_STAGED_MAX_D, DENSE_STAGED_MAX_D + 1,
            DENSE_SPLIT_MAX_D, DENSE_SPLIT_MAX_D + 1]


def _dense_variant(d, wide, small):
    """The variant B2 (``small``: staged) or B3 (stream) takes for rows
    of d floats."""
    if wide or d > DENSE_SPLIT_MAX_D:
        return "wide"
    return "split" if d > DENSE_STAGED_MAX_D else small


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["by_shape", "wide"])
@pytest.mark.parametrize("d", DENSE_DS)
@pytest.mark.parametrize("loss", LOSSES)
def test_b2_variants_match_plain(loss, d, wide):
    """B2's variant for the shape (or the wide one, asked for) against
    the plain version, with mask, labels and repeated ids in a block of
    64."""
    dev = _cuda()
    X, alpha, w, active, y, idx = _dense_case(dev, 300, d)
    assert idx.shape[0] == 64 and idx[-5] == idx[-4]  # a repeated id
    variant = dcd_dense_plan(64, d, wide).variant
    assert variant == _dense_variant(d, wide, "staged")
    q = (X * X).sum(1)
    kw = dict(loss=td.make_loss(loss, 0.8), idx=idx, active=active, y=y)
    n0 = (dcd_indexed_epoch.launches,
          dcd_indexed_epoch.variant_launches[variant])
    ka, kw_ = dcd_indexed_epoch(X, alpha, w, q, wide=wide, **kw)
    assert (dcd_indexed_epoch.launches,
            dcd_indexed_epoch.variant_launches[variant]) == (n0[0] + 1,
                                                             n0[1] + 1)
    pa, pw = dcd_indexed_epoch_plain(X, alpha, w, q, **kw)
    _close(ka, pa)
    _close(kw_, pw)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["by_shape", "wide"])
@pytest.mark.parametrize("d", DENSE_DS)
def test_b2_kernel_is_deterministic(d, wide):
    """A second launch on the same inputs gives the same bits."""
    dev = _cuda()
    X, alpha, w, active, y, idx = _dense_case(dev, 300, d)
    q = (X * X).sum(1)
    kw = dict(loss=td.Hinge(0.8), idx=idx, active=active, y=y, wide=wide)
    first = dcd_indexed_epoch(X, alpha, w, q, **kw)
    second = dcd_indexed_epoch(X, alpha, w, q, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# B3's epochs: (rows, first row) of a draw of 3T + 6 rows; from row 1 the
# view's base and its q's are not 16-byte aligned (the stages are copied
# in 4-byte units)
B3_ROWS = {"one": (1, 0), "tile_less_one": (TILE_STREAM_ROWS - 1, 0),
           "tile": (TILE_STREAM_ROWS, 0),
           "ragged": (3 * TILE_STREAM_ROWS + 5, 0),
           "ragged_unaligned": (3 * TILE_STREAM_ROWS + 5, 1)}
B3_DS = [1, 54, DENSE_STAGED_MAX_D, DENSE_STAGED_MAX_D + 1, 1000, 5120]


def _tile_case(dev, d, rows, first, seed=11):
    X, alpha, w, _, _, _ = _dense_case(dev, 3 * TILE_STREAM_ROWS + 6, d,
                                       seed=seed)
    q = (X * X).sum(1)
    sl = slice(first, first + rows)
    return X[sl], alpha[sl], w, q[sl]


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["by_shape", "wide"])
@pytest.mark.parametrize("rows", sorted(B3_ROWS))
@pytest.mark.parametrize("d", B3_DS)
@pytest.mark.parametrize("loss", LOSSES)
def test_b3_variants_match_plain(loss, d, rows, wide):
    """B3's variant for the shape (or the wide one, asked for) against
    the plain version: one row, a tile less one, one tile, three tiles
    and a ragged one, and the same from an unaligned view."""
    dev = _cuda()
    X, alpha, w, q = _tile_case(dev, d, *B3_ROWS[rows])
    variant = dcd_tile_plan(X.shape[0], d, wide).variant
    assert variant == _dense_variant(d, wide, "stream")
    if rows == "ragged_unaligned":
        assert q.data_ptr() % 16 != 0
    lf = td.make_loss(loss, 0.8)
    n0 = (dcd_tile_epoch.launches, dcd_tile_epoch.variant_launches[variant])
    ka, kw = dcd_tile_epoch(X, alpha, w, q, loss=lf, wide=wide)
    assert (dcd_tile_epoch.launches,
            dcd_tile_epoch.variant_launches[variant]) == (n0[0] + 1,
                                                          n0[1] + 1)
    pa, pw = dcd_tile_epoch_plain(X, alpha, w, q, loss=lf)
    _close(ka, pa)
    _close(kw, pw)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["by_shape", "wide"])
@pytest.mark.parametrize("rows", ["ragged", "ragged_unaligned"])
@pytest.mark.parametrize("d", B3_DS)
def test_b3_kernel_is_deterministic(d, rows, wide):
    """A second launch on the same inputs gives the same bits."""
    dev = _cuda()
    X, alpha, w, q = _tile_case(dev, d, *B3_ROWS[rows])
    kw = dict(loss=td.Hinge(0.8), wide=wide)
    first = dcd_tile_epoch(X, alpha, w, q, **kw)
    second = dcd_tile_epoch(X, alpha, w, q, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# B2's stream variant: d of the rows (a stage copied in 16-, 8- or 4-byte
# units: 64, covtype's 54, 7; and the widest, 256)
B2_STREAM_DS = [7, 54, 64, DENSE_STAGED_MAX_D]


def _dense_stream_case(dev, d, n=3000, b=9000):
    """``_dense_case``'s rows and state, and ``b`` ids past the staged
    kernel's 1,024 with an id recurring at every distance of the ring's
    lookahead."""
    X, alpha, w, active, y, _ = _dense_case(dev, n, d)
    plan = dcd_dense_plan(b, d)
    assert plan.variant == "stream"
    idx = _stream_ids(n, b, plan.tile_rows * plan.stages)
    return X, alpha, w, active, y, torch.from_numpy(idx).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("d", B2_STREAM_DS)
@pytest.mark.parametrize("loss", LOSSES)
def test_b2_stream_matches_plain(loss, d, masked):
    """B2's stream variant against the plain version (on host copies)
    and against the wide variant."""
    dev = _cuda()
    X, alpha, w, active, y, idx = _dense_stream_case(dev, d)
    q = (X * X).sum(1)
    kw = dict(loss=td.make_loss(loss, 0.8), idx=idx)
    if masked:
        kw.update(active=active, y=y)
    n0 = dict(dcd_indexed_epoch.variant_launches)
    ka, kw_ = dcd_indexed_epoch(X, alpha, w, q, **kw)
    wa, ww = dcd_indexed_epoch(X, alpha, w, q, wide=True, **kw)
    assert dcd_indexed_epoch.variant_launches == {
        "staged": n0["staged"], "stream": n0["stream"] + 1,
        "split": n0["split"], "wide": n0["wide"] + 1}
    host = {key: v.cpu() if torch.is_tensor(v) else v
            for key, v in kw.items()}
    pa, pw = dcd_indexed_epoch_plain(X.cpu(), alpha.cpu(), w.cpu(),
                                     q.cpu(), **host)
    _close(ka, pa)
    _close(kw_, pw)
    _close(ka, wa)
    _close(kw_, ww)


@pytest.mark.cuda
@pytest.mark.parametrize("d", B2_STREAM_DS)
def test_b2_stream_is_deterministic(d):
    """A second launch on the same inputs gives the same bits."""
    dev = _cuda()
    X, alpha, w, active, y, idx = _dense_stream_case(dev, d)
    q = (X * X).sum(1)
    kw = dict(loss=td.Hinge(0.8), idx=idx, active=active, y=y)
    first = dcd_indexed_epoch(X, alpha, w, q, **kw)
    second = dcd_indexed_epoch(X, alpha, w, q, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# B2's split variant: d of the rows past 256 floats (a row's window copied
# from any of its four word offsets: 257 and 1,000 are not multiples of 4
# or 32), the probe's 5,120 and the widest, 8,192
B2_SPLIT_DS = [257, 1000, 5120, DENSE_SPLIT_MAX_D]


def _dense_split_case(dev, d, n=600, b=2000):
    """``_dense_case``'s rows and state, and ``b`` ids with an id
    recurring at every distance of the split ring's lookahead."""
    X, alpha, w, active, y, _ = _dense_case(dev, n, d)
    plan = dcd_dense_plan(b, d)
    assert plan.variant == "split"
    idx = _stream_ids(n, b, plan.tile_rows * plan.stages)
    return X, alpha, w, active, y, torch.from_numpy(idx).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("d", B2_SPLIT_DS)
@pytest.mark.parametrize("loss", LOSSES)
def test_b2_split_matches_plain(loss, d, masked):
    """B2's split variant against the plain version (on host copies) and
    against the wide variant, ids recurring at every distance of its
    ring's lookahead; a second launch gives the same bits."""
    dev = _cuda()
    X, alpha, w, active, y, idx = _dense_split_case(dev, d)
    q = (X * X).sum(1)
    kw = dict(loss=td.make_loss(loss, 0.8), idx=idx)
    if masked:
        kw.update(active=active, y=y)
    n0 = dict(dcd_indexed_epoch.variant_launches)
    ka, kw_ = dcd_indexed_epoch(X, alpha, w, q, **kw)
    wa, ww = dcd_indexed_epoch(X, alpha, w, q, wide=True, **kw)
    assert dcd_indexed_epoch.variant_launches == {
        "staged": n0["staged"], "stream": n0["stream"],
        "split": n0["split"] + 1, "wide": n0["wide"] + 1}
    host = {key: v.cpu() if torch.is_tensor(v) else v
            for key, v in kw.items()}
    pa, pw = dcd_indexed_epoch_plain(X.cpu(), alpha.cpu(), w.cpu(),
                                     q.cpu(), **host)
    _close(ka, pa)
    _close(kw_, pw)
    _close(ka, wa)
    _close(kw_, ww)
    again = dcd_indexed_epoch(X, alpha, w, q, **kw)
    torch.cuda.synchronize()
    assert torch.equal(again[0], ka) and torch.equal(again[1], kw_)


def _offset(t):
    """A copy of ``t`` one word into a larger allocation: its data 4
    bytes past a 16-byte boundary, so that row 0's 16-byte-aligned window
    starts before the array."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["b1", "b2", "b2_split"])
def test_stream_takes_rows_at_any_offset(kernel):
    """The stream kernels on rows in arrays that start 4 bytes past a
    16-byte boundary (views into a larger allocation), row 0 among the
    ids: its aligned window would start before the array, so it is copied
    word by word.  Against the plain version on host copies."""
    dev = _cuda()
    if kernel == "b1":
        cols, vals, alpha, w, active, y, idx = _stream_case(
            dev, "narrow_w_shared")
        X = (_offset(cols), _offset(vals))
        run, plain, counts = dcd_ell_epoch, dcd_ell_epoch_plain, \
            dcd_ell_epoch.variant_launches
    else:
        X, alpha, w, active, y, idx = (_dense_stream_case(dev, 54)
                                       if kernel == "b2" else
                                       _dense_split_case(dev, 1000))
        X = (_offset(X),)
        run, plain, counts = dcd_indexed_epoch, dcd_indexed_epoch_plain, \
            dcd_indexed_epoch.variant_launches
    variant = "split" if kernel == "b2_split" else "stream"
    idx[0] = 0
    q = (X[-1] * X[-1]).sum(1)
    kw = dict(loss=td.Hinge(0.8), idx=idx, active=active, y=y)
    n0 = counts[variant]
    ka, kw_ = run(*X, alpha, w, q, **kw)
    assert counts[variant] == n0 + 1
    host = {key: v.cpu() if torch.is_tensor(v) else v
            for key, v in kw.items()}
    pa, pw = plain(*(x.cpu() for x in X), alpha.cpu(), w.cpu(), q.cpu(),
                   **host)
    _close(ka, pa)
    _close(kw_, pw)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [54, 1000], ids=["stream", "split"])
@pytest.mark.parametrize("grid", sorted(STREAM_GRIDS))
def test_b2_stream_grids_match_plain(grid, d):
    """B2's stream variant (and the split variant, at rows of 1,000
    floats) over the shard, task and pod grids, a replica of w a (task,
    shard) pair, against its plain version and the wide variant; a second
    launch gives the same bits."""
    from repro_torch.kernels.dcd_block import (
        dcd_indexed_shards,
        dcd_indexed_shards_plain,
    )
    dev = _cuda()
    K, P, p, n_loc, b = STREAM_GRIDS[grid]
    S = P * p
    variant = "stream" if d == 54 else "split"
    rng = np.random.default_rng(42)
    X = torch.from_numpy((rng.standard_normal((n_loc * S, d)) * 0.3 /
                          np.sqrt(d)).astype(np.float32)).to(dev)
    alpha, w, act, y = _grid_operands(rng, grid, d, n_loc * S, dev)
    ids = _task_ids(rng, K, n_loc, S, b, dev, True)
    q = (X * X).sum(1)
    plan = dcd_dense_plan(b, d, False, p, K, P)
    assert plan == dcd_dense_plan(b, d)._replace(shards=p, tasks=K, pods=P)
    assert plan.variant == variant
    kw = dict(loss=td.Hinge(0.8), idx=ids, n_loc=n_loc, active=act, y=y)
    n0 = dcd_indexed_shards.variant_launches[variant]
    ka, kdw = dcd_indexed_shards(X, alpha, w, q, **kw)
    assert dcd_indexed_shards.variant_launches[variant] == n0 + 1
    pa, pdw = dcd_indexed_shards_plain(X, alpha, w, q, **kw)
    _close(ka, pa)
    _close(kdw, pdw)
    wa, wdw = dcd_indexed_shards(X, alpha, w, q, wide=True, **kw)
    _close(ka, wa)
    _close(kdw, wdw)
    again = dcd_indexed_shards(X, alpha, w, q, **kw)
    torch.cuda.synchronize()
    assert torch.equal(again[0], ka) and torch.equal(again[1], kdw)


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


@pytest.mark.cuda
@pytest.mark.parametrize("ell", [True, False], ids=["ell", "dense"])
@pytest.mark.parametrize("memory_model,delay", [
    ("lock", 0), ("atomic", 0), ("atomic", 2), ("wild", 0), ("wild", 2)])
def test_passcode_card_matches_cpu(ell, memory_model, delay):
    """PASSCoDe on the card against its CPU path on ``tiny``, 3 epochs:
    Lock (the indexed kernel against its plain version) and Atomic as
    whole solves; Wild one epoch at a time from the CPU path's state,
    since a rounding flip of a δ at a bound switches a feature between
    the sum and the last writer (``test_torch_passcode.py``)."""
    dev = _cuda()
    ds = make_dataset("tiny", device="cpu")
    X = ds.X_train if ell else ds.dense_train()
    kw = dict(n_threads=8, memory_model=memory_model, delay=delay)
    if memory_model != "wild":
        on_card = passcode_solve(X, td.Hinge(), epochs=3, seed=1, **kw)
        on_cpu = passcode_solve(X, td.Hinge(), epochs=3, seed=1,
                                device="cpu", **kw)
        for a, b in [(on_card.alpha, on_cpu.alpha),
                     (on_card.w_hat, on_cpu.w_hat),
                     (on_card.w_bar, on_cpu.w_bar)]:
            _close(a, b)
        return
    sq = X.row_sq_norms() if ell else torch.sum(X * X, dim=1)
    n, d = (X.n_rows, X.n_features) if ell else X.shape
    alpha, w = torch.zeros(n), torch.zeros(d)
    key = prng.PRNGKey(1)
    for _ in range(3):
        key, sub = prng.split(key)
        card = passcode_epoch(X, sq, alpha, w, sub, td.Hinge(), **kw)
        alpha, w = passcode_epoch(X, sq, alpha, w, sub, td.Hinge(),
                                  device="cpu", **kw)
        _close(card[0], alpha)
        _close(card[1], w)


def _feature_case(dev, n=300, m=3, k=40, d_loc=500, b=48, seed=7,
                  repeat_col=True, col_step=1):
    """Shard-local ELL slices with ragged rows (trailing padding id
    d_loc), a repeated column (unless ``repeat_col`` is False), primal
    slices with zero dummy slots, and a block with repeated ids (when it
    has room).  Columns are drawn from the multiples of ``col_step``."""
    rng = np.random.default_rng(seed)
    cols = np.full((n, m, k), d_loc, np.int32)
    vals = np.zeros((n, m, k), np.float32)
    pool = np.arange(0, d_loc, col_step)
    for i in range(n):
        for j in range(m):
            nnz = rng.integers(0, min(k, pool.size) + 1)
            cols[i, j, :nnz] = rng.choice(pool, nnz, replace=False)
            vals[i, j, :nnz] = rng.standard_normal(nnz) * 0.1
    if repeat_col:
        cols[5, 1, 1] = cols[5, 1, 0]  # a repeated column accumulates
    w = (rng.standard_normal((m, d_loc + 1)) * 0.05).astype(np.float32)
    w[:, d_loc] = 0.0
    idx = rng.permutation(n)[:b].astype(np.int32)
    if b > 21:
        idx[[7, 20, 21]] = [5, idx[3], 5]
    return [torch.from_numpy(a).to(dev) for a in (cols, vals, w, idx)]


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "plain"])
@pytest.mark.parametrize("loss", LOSSES)
def test_b4_b5_kernels_match_plain(loss, masked):
    dev = _cuda()
    cols, vals, w, idx = _feature_case(dev)
    n, m, k = cols.shape
    ws = feat.gram_workspace(m, idx.shape[0], k, w.shape[1], dev)
    n0 = (feat.dcd_feature_gram.launches, feat.dcd_feature_update.launches)
    kb, kg = feat.dcd_feature_gram(cols, vals, w, idx, workspace=ws)
    pb, pg = feat.dcd_feature_gram_plain(cols, vals, w, idx)
    _close(kb, pb)
    _close(kg, pg)
    rng = np.random.default_rng(8)
    alpha, _, active, y, _ = _state(rng, n, 1, dev)
    q = (vals * vals).sum((1, 2))
    kw = dict(loss=td.make_loss(loss, 0.8))
    if masked:
        kw.update(active=active, y=y)
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


# B4 at the edges of its layout: one id; 1,024 ids (one column class,
# G's columns in 256 tiles, the class staged in chunks); every entry in
# one of 256 column classes (its columns are multiples of 256), staged in
# chunks; rows wider than 1,024 slots
GRAM_CASES = {
    "b1": dict(b=1),
    "b1024": dict(n=1100, m=2, k=20, b=1024),
    "one_class": dict(n=200, m=2, k=40, d_loc=65_536, b=64, col_step=256),
    "rows_1100_wide": dict(n=40, m=2, k=1100, d_loc=30_000, b=16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GRAM_CASES))
def test_b4_kernel_layout_edges(case):
    dev = _cuda()
    cols, vals, w, idx = _feature_case(dev, **GRAM_CASES[case])
    n, m, k = cols.shape
    plan = gram_plan(m, idx.shape[0], k, w.shape[1])
    if case == "one_class":
        real = cols[idx.long()][cols[idx.long()] < 65_536]
        assert plan.classes == 256 and int((real % 256).max()) == 0
        assert real.numel() > GRAM_CHUNK  # the class is staged in chunks
    kb, kg = feat.dcd_feature_gram(cols, vals, w, idx)
    pb, pg = feat.dcd_feature_gram_plain(cols, vals, w, idx)
    _close(kb, pb)
    _close(kg, pg)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["default", "rows_1100_wide"])
def test_b4_kernel_is_deterministic(case):
    """No row repeats a column: a second launch gives the same bits."""
    dev = _cuda()
    cols, vals, w, idx = _feature_case(dev, repeat_col=False,
                                       **GRAM_CASES.get(case, {}))
    first = feat.dcd_feature_gram(cols, vals, w, idx)
    second = feat.dcd_feature_gram(cols, vals, w, idx)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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


# B5 at its block sizes: (feature case, column classes R > 1 or R = 1);
# at B = 256 and 1,024 G is read from device memory, not staged
FEATURE_UPDATE_CASES = {
    "b1": (dict(b=1), True),
    "b64": (dict(b=64), True),
    "b64_one_class": (dict(b=64, d_loc=60), False),
    "b256": (dict(b=256), True),
    "b1024_one_class": (dict(n=1100, m=2, k=20, b=1024), False),
}


def _b5_inputs(dev, case, repeat_col=True):
    spec, many_classes = FEATURE_UPDATE_CASES[case]
    cols, vals, w, idx = _feature_case(dev, repeat_col=repeat_col, **spec)
    n, m, k = cols.shape
    b = idx.shape[0]
    plan = feature_update_plan(m, b, k, w.shape[1])
    assert (plan.classes > 1) == many_classes
    assert plan.stage_gram == (b <= 64)
    pb, pg = feat.dcd_feature_gram_plain(cols, vals, w, idx)
    rng = np.random.default_rng(8)
    alpha, _, active, y, _ = _state(rng, n, 1, dev)
    q = (vals * vals).sum((1, 2))
    return cols, vals, w, idx, alpha, q, active, y, pb.sum(0), pg.sum(0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FEATURE_UPDATE_CASES))
@pytest.mark.parametrize("loss", LOSSES)
def test_b5_kernel_matches_plain(loss, case):
    """B5 with mask, labels, repeated ids and a row that repeats a column
    against the plain version: with B4's workspace filled for the same
    block, and without one (its own bucket pass)."""
    dev = _cuda()
    cols, vals, w, idx, alpha, q, active, y, base, gram = _b5_inputs(dev,
                                                                     case)
    n, m, k = cols.shape
    ws = feat.gram_workspace(m, idx.shape[0], k, w.shape[1], dev)
    feat.dcd_feature_gram(cols, vals, w, idx, workspace=ws)
    kw = dict(loss=td.make_loss(loss, 0.8), active=active, y=y)
    n0 = feat.dcd_feature_update.launches
    ka, kwv = feat.dcd_feature_update(cols, vals, alpha, q, w, idx, base,
                                      gram, workspace=ws, **kw)
    sa, sw = feat.dcd_feature_update(cols, vals, alpha, q, w, idx, base,
                                     gram, **kw)
    assert feat.dcd_feature_update.launches == n0 + 2
    pa, pw = feat.dcd_feature_update_plain(cols, vals, alpha, q, w, idx,
                                           base, gram, **kw)
    for a in (ka, sa):
        _close(a, pa)
    for w_ in (kwv, sw):
        _close(w_, pw)
        assert float(w_[:, -1].abs().max()) == 0.0  # dummy slots stay 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FEATURE_UPDATE_CASES))
def test_b5_kernel_is_deterministic(case):
    """No row repeats a column: a second launch gives the same bits, and
    so does the call without a workspace."""
    dev = _cuda()
    cols, vals, w, idx, alpha, q, active, y, base, gram = _b5_inputs(
        dev, case, repeat_col=False)
    n, m, k = cols.shape
    ws = feat.gram_workspace(m, idx.shape[0], k, w.shape[1], dev)
    feat.dcd_feature_gram(cols, vals, w, idx, workspace=ws)
    kw = dict(loss=td.Hinge(0.8), active=active, y=y)
    first = feat.dcd_feature_update(cols, vals, alpha, q, w, idx, base, gram,
                                    workspace=ws, **kw)
    second = feat.dcd_feature_update(cols, vals, alpha, q, w, idx, base,
                                     gram, workspace=ws, **kw)
    alone = feat.dcd_feature_update(cols, vals, alpha, q, w, idx, base, gram,
                                    **kw)
    for a, b, c in zip(first, second, alone):
        assert torch.equal(a, b) and torch.equal(a, c)


# ------------------------------------------ B4/B5 past 1,024 ids (rows)
# (feature case, data shards): the rows layout at 1,025 and 1,500 ids,
# one data shard and two
ROWS_CASES = {"b1025": (dict(n=1100, m=2, k=20, b=1025), 1),
              "b1500": (dict(n=1600, m=3, k=12, d_loc=300, b=1500), 1),
              "b1100_data2": (dict(n=2400, m=2, k=16, b=1100), 2),
              "b4096": (dict(n=4200, m=4, k=12, d_loc=2000, b=4096), 1)}


def _rows_inputs(dev, case, repeat_col=True):
    spec, p = ROWS_CASES[case]
    cols, vals, w, idx = _feature_case(dev, repeat_col=repeat_col, **spec)
    n, m, k = cols.shape
    if p > 1:  # shard s's ids local to its rows [s·n/p, (s+1)·n/p)
        rng = np.random.default_rng(3)
        idx = torch.from_numpy(rng.integers(0, n // p, (p, spec["b"]))
                               .astype(np.int32)).to(dev)
    else:  # an id recurring at each distance 1 … 97, within a panel of
        # B5's 32 steps, in the next panel and past it, from position 30
        ids = idx.cpu().numpy()
        pos = 30
        for dist in range(1, 98):
            if pos + dist >= ids.size:
                break
            ids[pos + dist] = ids[pos]
            pos += dist + 1
        idx = torch.from_numpy(ids).to(dev)
    assert gram_plan(m, spec["b"], k, w.shape[1], p).layout == "rows"
    rng = np.random.default_rng(8)
    alpha, _, active, y, _ = _state(rng, n, 1, dev)
    q = (vals * vals).sum((1, 2))
    return cols, vals, w, idx, alpha, q, active, y, n // p


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ROWS_CASES))
@pytest.mark.parametrize("loss", LOSSES)
def test_b4_b5_rows_layout_match_plain(loss, case):
    """Past 1,024 ids: B4's G in row tiles and B5's CTA recursion against
    their plain versions, with a mask, labels, repeated ids and a row
    that repeats a column; B5 with B4's workspace and without one."""
    dev = _cuda()
    cols, vals, w, idx, alpha, q, active, y, n_loc = _rows_inputs(dev, case)
    n, m, k = cols.shape
    p = idx.shape[0] if idx.dim() == 2 else 1
    ws = feat.gram_workspace(m, idx.shape[-1], k, w.shape[1], dev, p)
    r0 = (feat.dcd_feature_gram.rows_launches,
          feat.dcd_feature_update.rows_launches)
    kb, kg = feat.dcd_feature_gram(cols, vals, w, idx, workspace=ws,
                                   n_loc=n_loc)
    pb, pg = feat.dcd_feature_gram_plain(cols, vals, w, idx, n_loc)
    _close(kb, pb)
    _close(kg, pg)
    base, gram = pb.sum(-2), pg.sum(-3)
    kw = dict(loss=td.make_loss(loss, 0.8), active=active, y=y,
              n_loc=n_loc)
    ka, kwv = feat.dcd_feature_update(cols, vals, alpha, q, w, idx, base,
                                      gram, workspace=ws, **kw)
    sa, sw = feat.dcd_feature_update(cols, vals, alpha, q, w, idx, base,
                                     gram, **kw)
    assert (feat.dcd_feature_gram.rows_launches,
            feat.dcd_feature_update.rows_launches) == (r0[0] + 1, r0[1] + 2)
    pa, pw = feat.dcd_feature_update_plain(cols, vals, alpha, q, w, idx,
                                           base, gram, **kw)
    for a in (ka, sa):
        _close(a, pa)
    for w_ in (kwv, sw):
        _close(w_, pw)


@pytest.mark.cuda
def test_b5_rows_layout_accumulators_in_device_memory(monkeypatch):
    """B5's rows layout with its accumulators in device memory (the plan
    past 69,632 ids, forced here at 1,025) gives the shared-memory
    accumulators' bits."""
    dev = _cuda()
    cols, vals, w, idx, alpha, q, active, y, _ = _rows_inputs(
        dev, "b1025", repeat_col=False)
    base, gram = (t.sum(0) for t in
                  feat.dcd_feature_gram_plain(cols, vals, w, idx))
    kw = dict(loss=td.Hinge(0.8), active=active, y=y)
    in_smem = feat.dcd_feature_update(cols, vals, alpha, q, w, idx, base,
                                      gram, **kw)
    plan = feat.feature_update_plan
    monkeypatch.setattr(feat, "feature_update_plan",
                        lambda *a: plan(*a)._replace(acc_shared=False))
    in_hbm = feat.dcd_feature_update(cols, vals, alpha, q, w, idx, base,
                                     gram, **kw)
    assert all(torch.equal(a, b) for a, b in zip(in_smem, in_hbm))


@pytest.mark.cuda
def test_b4_b5_rows_layout_are_deterministic():
    """No row repeats a column: second launches give the same bits."""
    dev = _cuda()
    cols, vals, w, idx, alpha, q, active, y, _ = _rows_inputs(
        dev, "b1500", repeat_col=False)
    first = feat.dcd_feature_gram(cols, vals, w, idx)
    second = feat.dcd_feature_gram(cols, vals, w, idx)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    base, gram = first[0].sum(0), first[1].sum(0)
    kw = dict(loss=td.Hinge(0.8), active=active, y=y)
    one = feat.dcd_feature_update(cols, vals, alpha, q, w, idx, base, gram,
                                  **kw)
    two = feat.dcd_feature_update(cols, vals, alpha, q, w, idx, base, gram,
                                  **kw)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.cuda
def test_feature_shim_on_the_card_matches_cpu():
    """The shim's one block of n = 1,200 rows an epoch on the card (B4 and
    B5 in their rows layout) against its CPU path (the unfused engine)."""
    dev = _cuda()
    rng = np.random.default_rng(11)
    X = torch.from_numpy((rng.random((1200, 40)) < 0.2)
                         * rng.standard_normal((1200, 40)).astype(
                             np.float32) * 0.3).float()
    n0 = feat.dcd_feature_update.rows_launches
    a_card, w_card = sharded_passcode_feature(
        X.to(dev), td.Hinge(), mesh=solver_mesh_2d(model=2), epochs=2)
    assert feat.dcd_feature_update.rows_launches == n0 + 2
    a_cpu, w_cpu = sharded_passcode_feature(
        X, td.Hinge(), mesh=solver_mesh_2d(model=2), epochs=2, device="cpu")
    _close(a_card, a_cpu)
    _close(w_card, w_cpu)


# ------------------------------------------------- data shards (a grid)
# (n_loc, p, b): B1/B2 over p data shards of n_loc rows, b ids each; the
# last has more shards than the card has SMs, so the result must not rest
# on which CTAs run together
SHARD_GRIDS = {"p3": (64, 3, 24), "p8": (25, 8, 16), "p150": (2, 150, 3)}


def _shard_ids(rng, n_loc, p, b, dev):
    ids = rng.integers(0, n_loc, (p, b)).astype(np.int32)
    ids[:, -1] = ids[:, 0]  # a repeated id in every shard
    return torch.from_numpy(ids).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("per_shard_w", [False, True], ids=["one_w", "own_w"])
@pytest.mark.parametrize("wide", [False, True], ids=["by_shape", "wide"])
@pytest.mark.parametrize("grid", sorted(SHARD_GRIDS))
@pytest.mark.parametrize("loss", LOSSES)
def test_b1_shard_grid_matches_plain(loss, grid, wide, per_shard_w):
    from repro_torch.kernels.dcd_ell import (
        dcd_ell_shards,
        dcd_ell_shards_plain,
    )
    dev = _cuda()
    n_loc, p, b = SHARD_GRIDS[grid]
    cols, vals, alpha, w, active, y, _ = _ell_case(dev, n_loc * p, 300, 37,
                                                   4)
    rng = np.random.default_rng(11)
    ids = _shard_ids(rng, n_loc, p, b, dev)
    if per_shard_w:  # each shard its own w, at w's own scale
        w = w + 0.001 * torch.arange(p, device=dev)[:, None]
        w[:, -1] = 0.0
    q = (vals * vals).sum(1)
    kw = dict(loss=td.make_loss(loss, 0.8), idx=ids, n_loc=n_loc,
              active=active, y=y)
    variant = "wide" if wide else "staged"
    assert dcd_ell_plan(b, 37, 300, wide, p) == dcd_ell_plan(
        b, 37, 300, wide)._replace(shards=p)
    n0 = dcd_ell_shards.variant_launches[variant]
    ka, kdw = dcd_ell_shards(cols, vals, alpha, w, q, wide=wide, **kw)
    assert dcd_ell_shards.variant_launches[variant] == n0 + 1
    pa, pdw = dcd_ell_shards_plain(cols, vals, alpha, w, q, **kw)
    _close(ka, pa)
    _close(kdw, pdw)
    assert float(kdw[:, -1].abs().max()) == 0.0  # the dummy slots
    again = dcd_ell_shards(cols, vals, alpha, w, q, wide=wide, **kw)
    torch.cuda.synchronize()
    assert torch.equal(again[0], ka) and torch.equal(again[1], kdw)


@pytest.mark.cuda
@pytest.mark.parametrize("per_shard_w", [False, True], ids=["one_w", "own_w"])
@pytest.mark.parametrize("d", [54, 300], ids=["staged", "wide"])
@pytest.mark.parametrize("grid", sorted(SHARD_GRIDS))
@pytest.mark.parametrize("loss", LOSSES)
def test_b2_shard_grid_matches_plain(loss, grid, d, per_shard_w):
    from repro_torch.kernels.dcd_block import (
        dcd_indexed_shards,
        dcd_indexed_shards_plain,
    )
    dev = _cuda()
    n_loc, p, b = SHARD_GRIDS[grid]
    rng = np.random.default_rng(12)
    X = torch.from_numpy((rng.standard_normal((n_loc * p, d)) * 0.3 /
                          np.sqrt(d)).astype(np.float32)).to(dev)
    X[-1] = 0.0  # a padding row
    alpha, _, active, y, _ = _state(rng, n_loc * p, 1, dev)
    w = torch.from_numpy((rng.standard_normal((p, d) if per_shard_w else d)
                          * 0.1).astype(np.float32)).to(dev)
    ids = _shard_ids(rng, n_loc, p, b, dev)
    q = (X * X).sum(1)
    q[-1] = 1.0
    kw = dict(loss=td.make_loss(loss, 0.8), idx=ids, n_loc=n_loc,
              active=active, y=y)
    # rows of 300 floats (the case id'd "wide" since the wide kernel took
    # them) now take the split variant; the wide kernel is held as well
    variant = dcd_dense_plan(b, d, False, p).variant
    assert variant == ("staged" if d == 54 else "split")
    n0 = dcd_indexed_shards.variant_launches[variant]
    ka, kdw = dcd_indexed_shards(X, alpha, w, q, **kw)
    assert dcd_indexed_shards.variant_launches[variant] == n0 + 1
    pa, pdw = dcd_indexed_shards_plain(X, alpha, w, q, **kw)
    _close(ka, pa)
    _close(kdw, pdw)
    again = dcd_indexed_shards(X, alpha, w, q, **kw)
    torch.cuda.synchronize()
    assert torch.equal(again[0], ka) and torch.equal(again[1], kdw)
    if d != 54:
        wa, wdw = dcd_indexed_shards(X, alpha, w, q, wide=True, **kw)
        _close(wa, pa)
        _close(wdw, pdw)


@pytest.mark.cuda
@pytest.mark.parametrize("per_shard_w", [False, True], ids=["one_w", "own_w"])
@pytest.mark.parametrize("p", [2, 5])
@pytest.mark.parametrize("loss", LOSSES)
def test_b4_b5_data_grid_matches_plain(loss, p, per_shard_w):
    dev = _cuda()
    cols, vals, w, _ = _feature_case(dev, n=60 * p, repeat_col=False)
    n, m, k = cols.shape
    n_loc, b = 60, 16
    rng = np.random.default_rng(13)
    ids = _shard_ids(rng, n_loc, p, b, dev)
    if per_shard_w:
        w = (w[None] + 0.01 * torch.arange(p, device=dev)[:, None, None])
        w[..., -1] = 0.0
    ws = feat.gram_workspace(m, b, k, w.shape[-1], dev, p)
    assert ws.lc.shape == (p * m, b, k)
    n0 = (feat.dcd_feature_gram.launches, feat.dcd_feature_update.launches)
    kb, kg = feat.dcd_feature_gram(cols, vals, w, ids, workspace=ws,
                                   n_loc=n_loc)
    pb, pg = feat.dcd_feature_gram_plain(cols, vals, w, ids, n_loc)
    _close(kb, pb)
    _close(kg, pg)
    alpha, _, active, y, _ = _state(rng, n, 1, dev)
    q = (vals * vals).sum((1, 2))
    kw = dict(loss=td.make_loss(loss, 0.8), active=active, y=y, n_loc=n_loc)
    base, gram = pb.sum(1), pg.sum(1)
    ka, kwv = feat.dcd_feature_update(cols, vals, alpha, q, w, ids, base,
                                      gram, workspace=ws, **kw)
    sa, swv = feat.dcd_feature_update(cols, vals, alpha, q, w, ids, base,
                                      gram, **kw)  # its own bucket pass
    pa, pw = feat.dcd_feature_update_plain(cols, vals, alpha, q, w, ids,
                                           base, gram, **kw)
    _close(ka, pa)
    _close(kwv, pw)
    torch.cuda.synchronize()
    assert torch.equal(sa, ka) and torch.equal(swv, kwv)
    assert kwv.shape == (p, m, w.shape[-1])
    assert (feat.dcd_feature_gram.launches,
            feat.dcd_feature_update.launches) == (n0[0] + 1, n0[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [
    dict(dense=False, p=2), dict(dense=True, p=8),
    dict(dense=False, p=4, delay_rounds=1),
    dict(dense=False, p=4, shrink_every=1, repack=True),
    dict(dense=True, p=4, adaptive=True, delay_rounds=1,
         adaptive_ratio=0.5),
    dict(dense=False, p=2, model=2), dict(dense=False, p=2, model=2,
                                          delay_rounds=1),
    dict(dense=False, p=2, model=2, shrink_every=1)],
    ids=["ell_p2", "dense_p8", "ell_p4_delay", "ell_p4_shrink_repack",
         "dense_p4_adaptive", "2d_p2", "2d_p2_overlap", "2d_p2_shrink"])
def test_sharded_solver_kernel_path_matches_cpu_path(knobs):
    """p > 1 data shards on the card (the shard-grid kernels) against the
    same solve's CPU path (their plain versions; the fused 2-D engine on
    both)."""
    from repro_torch.dist.mesh import solver_mesh
    dev = _cuda()
    knobs = dict(knobs)
    ds = make_dataset("tiny", device="cpu")
    X = ds.dense_train() if knobs.pop("dense") else ds.X_train
    p, model = knobs.pop("p"), knobs.pop("model", None)
    mesh = (solver_mesh(n_devices=p) if model is None
            else solver_mesh_2d(data=p, model=model))
    kw = dict(mesh=mesh, epochs=4, block_size=16, seed=4, **knobs)
    on_card = sharded_passcode_solve(X.to(dev), td.Hinge(), **kw)
    on_cpu = sharded_passcode_solve(X, td.Hinge(), use_kernel=True,
                                    device="cpu", **kw)
    _close(on_card.alpha, on_cpu.alpha)
    _close(on_card.w_hat, on_cpu.w_hat)
    np.testing.assert_allclose(on_card.gaps.cpu().numpy(),
                               on_cpu.gaps.numpy(), rtol=1e-5, atol=ATOL)
    np.testing.assert_array_equal(on_card.active.cpu().numpy(),
                                  on_cpu.active.numpy())
    np.testing.assert_array_equal(on_card.delay.cpu().numpy(),
                                  on_cpu.delay.numpy())


# ---------------------------------------------- tasks (the multi-task grid)
# (K, n_loc, p, b): K tasks of p data shards; the last has more (task,
# shard) pairs than the card has SMs, and more tasks than shards
TASK_GRIDS = {"k3p2": (3, 40, 2, 16), "k53p3": (53, 8, 3, 6)}


def _task_operands(rng, K, n, w_shape, dev, shared):
    """K tasks' α, w, act (one mask for every task when ``shared``) and
    ±1 labels."""
    alpha = rng.uniform(0.05, 0.5, (K, n)).astype(np.float32)
    w = (rng.standard_normal((K, *w_shape)) * 0.1).astype(np.float32)
    act = (rng.random(n if shared else (K, n)) > 0.25).astype(np.float32)
    y = np.where(rng.random((K, n)) > 0.5, 1.0, -1.0).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (alpha, w, act, y)]


def _task_ids(rng, K, n_loc, p, b, dev, shared):
    ids = rng.integers(0, n_loc, (p, b) if shared else (K, p, b))
    ids[..., -1] = ids[..., 0]  # a repeated id in every block
    return torch.from_numpy(ids.astype(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "own"])
@pytest.mark.parametrize("wide", [False, True], ids=["by_shape", "wide"])
@pytest.mark.parametrize("grid", sorted(TASK_GRIDS))
@pytest.mark.parametrize("loss", LOSSES)
def test_b1_task_grid_matches_plain(loss, grid, wide, shared):
    """B1 over K tasks of p shards in one launch against its plain
    version: shared or per-task ids and masks, one w a task or a
    replica a (task, shard) pair; a second launch gives the same bits."""
    from repro_torch.kernels.dcd_ell import (
        dcd_ell_shards,
        dcd_ell_shards_plain,
    )
    dev = _cuda()
    K, n_loc, p, b = TASK_GRIDS[grid]
    cols, vals, *_ = _ell_case(dev, n_loc * p, 300, 37, 4)
    rng = np.random.default_rng(21)
    shape = (301,) if shared else (p, 301)
    alpha, w, act, y = _task_operands(rng, K, n_loc * p, shape, dev, shared)
    w[..., -1] = 0.0
    ids = _task_ids(rng, K, n_loc, p, b, dev, shared)
    q = (vals * vals).sum(1)
    kw = dict(loss=td.make_loss(loss, 0.8), idx=ids, n_loc=n_loc,
              active=act, y=y)
    variant = "wide" if wide else "staged"
    assert dcd_ell_plan(b, 37, 300, wide, p, K) == dcd_ell_plan(
        b, 37, 300, wide)._replace(shards=p, tasks=K)
    n0 = (dcd_ell_shards.variant_launches[variant],
          dcd_ell_shards.task_launches)
    ka, kdw = dcd_ell_shards(cols, vals, alpha, w, q, wide=wide, **kw)
    assert (dcd_ell_shards.variant_launches[variant],
            dcd_ell_shards.task_launches) == (n0[0] + 1, n0[1] + 1)
    pa, pdw = dcd_ell_shards_plain(cols, vals, alpha, w, q, **kw)
    assert kdw.shape == (K, p, 301)
    _close(ka, pa)
    _close(kdw, pdw)
    assert float(kdw[..., -1].abs().max()) == 0.0
    again = dcd_ell_shards(cols, vals, alpha, w, q, wide=wide, **kw)
    torch.cuda.synchronize()
    assert torch.equal(again[0], ka) and torch.equal(again[1], kdw)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "own"])
@pytest.mark.parametrize("d", [54, 300], ids=["staged", "wide"])
@pytest.mark.parametrize("grid", sorted(TASK_GRIDS))
@pytest.mark.parametrize("loss", LOSSES)
def test_b2_task_grid_matches_plain(loss, grid, d, shared):
    from repro_torch.kernels.dcd_block import (
        dcd_indexed_shards,
        dcd_indexed_shards_plain,
    )
    dev = _cuda()
    K, n_loc, p, b = TASK_GRIDS[grid]
    rng = np.random.default_rng(22)
    X = torch.from_numpy((rng.standard_normal((n_loc * p, d)) * 0.3 /
                          np.sqrt(d)).astype(np.float32)).to(dev)
    alpha, w, act, y = _task_operands(rng, K, n_loc * p,
                                      (d,) if shared else (p, d), dev,
                                      shared)
    ids = _task_ids(rng, K, n_loc, p, b, dev, shared)
    q = (X * X).sum(1)
    kw = dict(loss=td.make_loss(loss, 0.8), idx=ids, n_loc=n_loc,
              active=act, y=y)
    n0 = dcd_indexed_shards.task_launches
    ka, kdw = dcd_indexed_shards(X, alpha, w, q, **kw)
    assert dcd_indexed_shards.task_launches == n0 + 1
    pa, pdw = dcd_indexed_shards_plain(X, alpha, w, q, **kw)
    assert kdw.shape == (K, p, d)
    _close(ka, pa)
    _close(kdw, pdw)
    again = dcd_indexed_shards(X, alpha, w, q, **kw)
    torch.cuda.synchronize()
    assert torch.equal(again[0], ka) and torch.equal(again[1], kdw)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B1", "B2"])
def test_b1_b2_task_grid_k1_bit_equal_on_the_card(kernel):
    """One task of the task grid launches the task-free grid's
    arithmetic: the same bits as the binary-layout call."""
    from repro_torch.kernels.dcd_block import dcd_indexed_shards
    from repro_torch.kernels.dcd_ell import dcd_ell_shards
    dev = _cuda()
    rng = np.random.default_rng(23)
    n_loc, p, b = 40, 3, 16
    ids = _task_ids(rng, 1, n_loc, p, b, dev, True)
    if kernel == "B1":
        cols, vals, *_ = _ell_case(dev, n_loc * p, 300, 37, 4)
        X, q, width, fn = (cols, vals), (vals * vals).sum(1), 301, \
            dcd_ell_shards
    else:
        Xd = torch.from_numpy((rng.standard_normal((n_loc * p, 54)) * 0.05)
                              .astype(np.float32)).to(dev)
        X, q, width, fn = (Xd,), (Xd * Xd).sum(1), 54, dcd_indexed_shards
    alpha, w, act, y = _task_operands(rng, 1, n_loc * p, (width,), dev, True)
    w[..., -1] = 0.0 if kernel == "B1" else w[..., -1]
    kw = dict(loss=td.Logistic(0.7), idx=ids, n_loc=n_loc, active=act)
    ka, kdw = fn(*X, alpha, w, q, y=y, **kw)
    ba, bdw = fn(*X, alpha[0], w[0], q, y=y[0], **kw)
    torch.cuda.synchronize()
    assert torch.equal(ka[0], ba) and torch.equal(kdw[0], bdw)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "own"])
@pytest.mark.parametrize("K,p", [(3, 1), (2, 2)])
@pytest.mark.parametrize("loss", LOSSES)
def test_b4_b5_task_grid_matches_plain(loss, K, p, shared):
    """B4 and B5 over K tasks of p data shards (one launch each) against
    their plain versions; B5 with B4's workspace and with its own bucket
    pass to the same bits; K = 1 of the grid is the task-free call."""
    dev = _cuda()
    cols, vals, w1, _ = _feature_case(dev, n=60 * p, repeat_col=False)
    n, m, k = cols.shape
    n_loc, b, d1 = 60, 16, w1.shape[-1]
    rng = np.random.default_rng(24)
    ids = _task_ids(rng, K, n_loc, p, b, dev, shared)
    w = (w1[None] + 0.01 * torch.arange(K, device=dev)[:, None, None])
    w[..., -1] = 0.0
    ws = feat.gram_workspace(m, b, k, d1, dev, p, K)
    assert ws.lc.shape == (K * p * m, b, k)
    n0 = (feat.dcd_feature_gram.task_launches,
          feat.dcd_feature_update.task_launches)
    kb, kg = feat.dcd_feature_gram(cols, vals, w, ids, workspace=ws,
                                   n_loc=n_loc, tasks=True)
    pb, pg = feat.dcd_feature_gram_plain(cols, vals, w, ids, n_loc,
                                         tasks=True)
    assert kb.shape == (K, p, m, b) and kg.shape == (K, p, m, b, b)
    _close(kb, pb)
    _close(kg, pg)
    alpha, _, act, y = _task_operands(rng, K, n, (1,), dev, shared)
    q = (vals * vals).sum((1, 2))
    kw = dict(loss=td.make_loss(loss, 0.8), active=act, y=y, n_loc=n_loc)
    base, gram = pb.sum(2), pg.sum(2)
    ka, kwv = feat.dcd_feature_update(cols, vals, alpha, q, w, ids, base,
                                      gram, workspace=ws, **kw)
    sa, swv = feat.dcd_feature_update(cols, vals, alpha, q, w, ids, base,
                                      gram, **kw)
    pa, pw = feat.dcd_feature_update_plain(cols, vals, alpha, q, w, ids,
                                           base, gram, **kw)
    assert kwv.shape == (K, p, m, d1)
    _close(ka, pa)
    _close(kwv, pw)
    torch.cuda.synchronize()
    assert torch.equal(sa, ka) and torch.equal(swv, kwv)
    assert (feat.dcd_feature_gram.task_launches,
            feat.dcd_feature_update.task_launches) == (n0[0] + 1, n0[1] + 2)
    if shared:  # one task of the grid: the task-free call's bits
        tb, tg = feat.dcd_feature_gram(cols, vals, w[:1], ids, n_loc=n_loc,
                                       tasks=True)
        fb, fg = feat.dcd_feature_gram(cols, vals, w[0], ids, n_loc=n_loc)
        ta, tw = feat.dcd_feature_update(
            cols, vals, alpha[:1], q, w[:1], ids, tb.sum(2), tg.sum(2),
            loss=kw["loss"], active=act, y=y[:1], n_loc=n_loc)
        fa, fw = feat.dcd_feature_update(
            cols, vals, alpha[0], q, w[0], ids, fb.sum(1), fg.sum(1),
            loss=kw["loss"], active=act, y=y[0], n_loc=n_loc)
        torch.cuda.synchronize()
        assert torch.equal(tb[0], fb) and torch.equal(tg[0], fg)
        assert torch.equal(ta[0], fa) and torch.equal(tw[0], fw)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [
    dict(dense=False, p=2, shrink_every=1, repack=True,
         repack_threshold=0.9),
    dict(dense=True, p=4, adaptive=True, delay_rounds=1,
         adaptive_ratio=0.5),
    dict(dense=False, p=2, model=2, delay_rounds=1)],
    ids=["ell_p2_shrink_repack", "dense_p4_adaptive", "2d_p2_overlap"])
def test_multitask_solver_kernel_path_matches_cpu_path(knobs):
    """A K = 3 one-vs-rest solve on the card (the task-grid kernels)
    against the same solve's CPU path (their plain versions): α and ŵ at
    atol 1e-5, every task's records equal."""
    from repro_torch.data.labels import ovr_labels
    from repro_torch.dist.mesh import solver_mesh
    dev = _cuda()
    knobs = dict(knobs)
    ds = make_dataset("tiny", device="cpu")
    X = ds.dense_train() if knobs.pop("dense") else ds.X_train
    n = ds.X_train.n_rows
    Y = ovr_labels(np.arange(n) * 7 % 3, 3, device="cpu")
    p, model = knobs.pop("p"), knobs.pop("model", None)
    mesh = (solver_mesh(n_devices=p) if model is None
            else solver_mesh_2d(data=p, model=model))
    kw = dict(mesh=mesh, epochs=4, block_size=16, seed=4, **knobs)
    on_card = sharded_passcode_solve(X.to(dev), td.Hinge(), y=Y.to(dev),
                                     **kw)
    card_rounds = list(sharded_passcode_solve.task_rounds)
    on_cpu = sharded_passcode_solve(X, td.Hinge(), y=Y, use_kernel=True,
                                    device="cpu", **kw)
    assert on_card.alpha.shape == (3, n)
    _close(on_card.alpha, on_cpu.alpha)
    _close(on_card.w_hat, on_cpu.w_hat)
    np.testing.assert_allclose(on_card.gaps.cpu().numpy(),
                               on_cpu.gaps.numpy(), rtol=1e-5, atol=ATOL)
    np.testing.assert_array_equal(on_card.active.cpu().numpy(),
                                  on_cpu.active.numpy())
    np.testing.assert_array_equal(on_card.delay.cpu().numpy(),
                                  on_cpu.delay.numpy())
    assert card_rounds == sharded_passcode_solve.task_rounds


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["1d_ell", "1d_dense", "2d"])
def test_multitask_k1_bit_identical_on_the_card(mesh):
    """K = 1 on the card: a (1, n) label matrix on unfolded rows gives
    the binary solve's α and ŵ on pre-folded rows bit for bit (the gap
    at rtol 1e-6: its w(α) is an ``index_add_`` with atomics)."""
    from repro_torch.dist.mesh import solver_mesh
    dev = _cuda()
    ds = make_dataset("tiny", device="cpu")
    n = ds.X_train.n_rows
    y = torch.from_numpy(np.where(np.arange(n) % 3 == 0, 1.0, -1.0)
                         .astype(np.float32))
    dense = ds.dense_train()
    X = dense if mesh == "1d_dense" else ds.X_train
    Xf = dense * y[:, None] if mesh == "1d_dense" else type(X)(
        X.indices, X.values * y[:, None], X.n_features)
    m = solver_mesh_2d(data=2, model=2) if mesh == "2d" else \
        solver_mesh(n_devices=4)
    kw = dict(mesh=m, epochs=2, block_size=16, seed=3)
    b = sharded_passcode_solve(Xf.to(dev), td.Hinge(), **kw)
    r = sharded_passcode_solve(X.to(dev), td.Hinge(), y=y[None].to(dev),
                               **kw)
    torch.cuda.synchronize()
    assert torch.equal(r.alpha[0], b.alpha)
    assert torch.equal(r.w_hat[0], b.w_hat)
    np.testing.assert_allclose(r.gaps[0].cpu().numpy(), b.gaps.cpu().numpy(),
                               rtol=1e-6)


# ------------------------------------------------- pods (the pod grid)
# (P, p, n_loc, b): P pods of p data shards, pod k's shards reading pod
# k's own view of w; the last has more shards than pods and one a pod
POD_GRIDS = {"P2p4": (2, 4, 25, 16), "P3p2": (3, 2, 20, 12),
             "P4p1": (4, 1, 30, 8)}


def _pod_views(rng, K, P, width, dev):
    """K tasks' (P, width) views of w, a pod's at its own scale."""
    w = (rng.standard_normal((K, P, width)) * 0.1).astype(np.float32)
    w += 0.01 * np.arange(P, dtype=np.float32)[None, :, None]
    return torch.from_numpy(w).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("tasks", [1, 3], ids=["binary", "k3"])
@pytest.mark.parametrize("wide", [False, True], ids=["by_shape", "wide"])
@pytest.mark.parametrize("grid", sorted(POD_GRIDS))
@pytest.mark.parametrize("loss", LOSSES)
def test_b1_pod_grid_matches_plain(loss, grid, wide, tasks):
    """B1 over P pods of p shards in one launch against its plain
    version, and against the same launch with each shard handed its
    pod's view as a view of its own (the bits of the pod-free grid); a
    second launch gives the same bits."""
    from repro_torch.kernels.dcd_ell import (
        dcd_ell_shards,
        dcd_ell_shards_plain,
    )
    dev = _cuda()
    P, p, n_loc, b = POD_GRIDS[grid]
    S = P * p
    cols, vals, *_ = _ell_case(dev, n_loc * S, 300, 37, 4)
    rng = np.random.default_rng(31)
    alpha, _, act, y = _task_operands(rng, tasks, n_loc * S, (1,), dev,
                                      True)
    w = _pod_views(rng, tasks, P, 301, dev)
    w[..., -1] = 0.0
    ids = _task_ids(rng, tasks, n_loc, S, b, dev, True)
    if tasks == 1:
        alpha, w, y = alpha[0], w[0], y[0]
    q = (vals * vals).sum(1)
    kw = dict(loss=td.make_loss(loss, 0.8), idx=ids, n_loc=n_loc,
              active=act, y=y)
    variant = "wide" if wide else "staged"
    assert dcd_ell_plan(b, 37, 300, wide, p, tasks, P) == dcd_ell_plan(
        b, 37, 300, wide)._replace(shards=p, tasks=tasks, pods=P)
    n0 = (dcd_ell_shards.variant_launches[variant],
          dcd_ell_shards.pod_launches)
    ka, kdw = dcd_ell_shards(cols, vals, alpha, w, q, wide=wide, **kw)
    assert (dcd_ell_shards.variant_launches[variant],
            dcd_ell_shards.pod_launches) == (n0[0] + 1, n0[1] + (p > 1))
    pa, pdw = dcd_ell_shards_plain(cols, vals, alpha, w, q, **kw)
    assert kdw.shape == (*alpha.shape[:-1], S, 301)
    _close(ka, pa)
    _close(kdw, pdw)
    assert float(kdw[..., -1].abs().max()) == 0.0
    own = w.repeat_interleave(p, dim=-2)  # each shard its pod's view
    oa, odw = dcd_ell_shards(cols, vals, alpha, own, q, wide=wide, **kw)
    again = dcd_ell_shards(cols, vals, alpha, w, q, wide=wide, **kw)
    torch.cuda.synchronize()
    assert torch.equal(oa, ka) and torch.equal(odw, kdw)
    assert torch.equal(again[0], ka) and torch.equal(again[1], kdw)


@pytest.mark.cuda
@pytest.mark.parametrize("tasks", [1, 3], ids=["binary", "k3"])
@pytest.mark.parametrize("d", [54, 300], ids=["staged", "wide"])
@pytest.mark.parametrize("grid", sorted(POD_GRIDS))
@pytest.mark.parametrize("loss", LOSSES)
def test_b2_pod_grid_matches_plain(loss, grid, d, tasks):
    from repro_torch.kernels.dcd_block import (
        dcd_indexed_shards,
        dcd_indexed_shards_plain,
    )
    dev = _cuda()
    P, p, n_loc, b = POD_GRIDS[grid]
    S = P * p
    rng = np.random.default_rng(32)
    X = torch.from_numpy((rng.standard_normal((n_loc * S, d)) * 0.3 /
                          np.sqrt(d)).astype(np.float32)).to(dev)
    alpha, _, act, y = _task_operands(rng, tasks, n_loc * S, (1,), dev,
                                      True)
    w = _pod_views(rng, tasks, P, d, dev)
    ids = _task_ids(rng, tasks, n_loc, S, b, dev, True)
    if tasks == 1:
        alpha, w, y = alpha[0], w[0], y[0]
    q = (X * X).sum(1)
    kw = dict(loss=td.make_loss(loss, 0.8), idx=ids, n_loc=n_loc,
              active=act, y=y)
    # rows of 300 floats (id'd "wide": the wide kernel took them) now take
    # the split variant; the wide kernel is held as well
    assert dcd_dense_plan(b, d, False, p, tasks, P).variant == (
        "staged" if d == 54 else "split")
    n0 = dcd_indexed_shards.pod_launches
    ka, kdw = dcd_indexed_shards(X, alpha, w, q, **kw)
    assert dcd_indexed_shards.pod_launches == n0 + (p > 1)
    pa, pdw = dcd_indexed_shards_plain(X, alpha, w, q, **kw)
    assert kdw.shape == (*alpha.shape[:-1], S, d)
    _close(ka, pa)
    _close(kdw, pdw)
    if d != 54:
        wa, wdw = dcd_indexed_shards(X, alpha, w, q, wide=True, **kw)
        _close(wa, pa)
        _close(wdw, pdw)
    own = w.repeat_interleave(p, dim=-2)
    oa, odw = dcd_indexed_shards(X, alpha, own, q, **kw)
    again = dcd_indexed_shards(X, alpha, w, q, **kw)
    torch.cuda.synchronize()
    assert torch.equal(oa, ka) and torch.equal(odw, kdw)
    assert torch.equal(again[0], ka) and torch.equal(again[1], kdw)


@pytest.mark.cuda
@pytest.mark.parametrize("tasks", [1, 2], ids=["binary", "k2"])
@pytest.mark.parametrize("P,p", [(2, 1), (2, 2), (3, 1)])
@pytest.mark.parametrize("loss", LOSSES)
def test_b4_b5_pod_grid_matches_plain(loss, P, p, tasks):
    """B4 and B5 over the (task, pod·data, model) triples in one launch
    each against their plain versions, and against the same launches
    with each data shard handed its pod's view as its own; B5 with B4's
    workspace and with its own bucket pass to the same bits."""
    dev = _cuda()
    S = P * p
    cols, vals, w1, _ = _feature_case(dev, n=40 * S, repeat_col=False)
    n, m, k = cols.shape
    n_loc, b, d1 = 40, 16, w1.shape[-1]
    rng = np.random.default_rng(33)
    ids = _task_ids(rng, tasks, n_loc, S, b, dev, True)
    w = (w1[None, None] + 0.01 * torch.arange(tasks * P, device=dev)
         .view(tasks, P, 1, 1))
    w[..., -1] = 0.0
    alpha, _, act, y = _task_operands(rng, tasks, n, (1,), dev, True)
    lead = dict(tasks=True) if tasks > 1 else {}
    if tasks == 1:
        w, alpha, y = w[0], alpha[0], y[0]
    ws = feat.gram_workspace(m, b, k, d1, dev, S, tasks)
    assert ws.lc.shape == (tasks * S * m, b, k)
    n0 = (feat.dcd_feature_gram.pod_launches,
          feat.dcd_feature_update.pod_launches)
    kb, kg = feat.dcd_feature_gram(cols, vals, w, ids, workspace=ws,
                                   n_loc=n_loc, **lead)
    pb, pg = feat.dcd_feature_gram_plain(cols, vals, w, ids, n_loc, **lead)
    _close(kb, pb)
    _close(kg, pg)
    q = (vals * vals).sum((1, 2))
    kw = dict(loss=td.make_loss(loss, 0.8), active=act, y=y, n_loc=n_loc)
    base, gram = pb.sum(-2), pg.sum(-3)
    ka, kwv = feat.dcd_feature_update(cols, vals, alpha, q, w, ids, base,
                                      gram, workspace=ws, **kw)
    sa, swv = feat.dcd_feature_update(cols, vals, alpha, q, w, ids, base,
                                      gram, **kw)
    pa, pw = feat.dcd_feature_update_plain(cols, vals, alpha, q, w, ids,
                                           base, gram, **kw)
    assert kwv.shape == (*alpha.shape[:-1], S, m, d1)
    _close(ka, pa)
    _close(kwv, pw)
    own = w.repeat_interleave(p, dim=-3)
    ob, og = feat.dcd_feature_gram(cols, vals, own, ids, n_loc=n_loc,
                                   **lead)
    oa, owv = feat.dcd_feature_update(cols, vals, alpha, q, own, ids, base,
                                      gram, **kw)
    torch.cuda.synchronize()
    assert torch.equal(sa, ka) and torch.equal(swv, kwv)
    assert torch.equal(ob, kb) and torch.equal(og, kg)
    assert torch.equal(oa, ka) and torch.equal(owv, kwv)
    assert (feat.dcd_feature_gram.pod_launches,
            feat.dcd_feature_update.pod_launches) == (
                n0[0] + (p > 1), n0[1] + 2 * (p > 1))


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [
    dict(dense=False, P=2, p=2, pod_delay_rounds=1),
    dict(dense=True, P=2, p=4, delay_rounds=1),
    dict(dense=False, P=3, p=1, pod_delay_rounds=2, adaptive=True,
         adaptive_ratio=0.5),
    dict(dense=False, P=2, p=1, model=2, pod_delay_rounds=1),
    dict(dense=False, P=2, p=2, model=2),
    dict(dense=True, P=2, p=2, tasks=3, pod_delay_rounds=1)],
    ids=["ell_P2p2_delay1", "dense_P2p4_inner", "ell_P3_adaptive",
         "2d_P2m2_delay1", "2d_P2p2m2", "dense_P2p2_k3"])
def test_pod_solver_kernel_path_matches_cpu_path(knobs):
    """The pod solve on the card (the pod-grid kernels) against the same
    solve's CPU path: α and ŵ at atol 1e-5, the records equal or at the
    gap's tolerance."""
    from repro_torch.data.labels import ovr_labels
    from repro_torch.dist.mesh import SolverMesh, solver_mesh_3d
    dev = _cuda()
    knobs = dict(knobs)
    ds = make_dataset("tiny", device="cpu")
    X = ds.dense_train() if knobs.pop("dense") else ds.X_train
    P, p, model = knobs.pop("P"), knobs.pop("p"), knobs.pop("model", None)
    K = knobs.pop("tasks", 0)
    mesh = (SolverMesh(("pod", "data"), (P, p)) if model is None
            else solver_mesh_3d(pod=P, data=p, model=model))
    n = ds.X_train.n_rows
    Y = ovr_labels(np.arange(n) * 7 % 3, 3, device="cpu") if K else None
    kw = dict(mesh=mesh, epochs=4, block_size=16, seed=4, **knobs)
    on_card = sharded_passcode_solve(
        X.to(dev), td.Hinge(), y=None if Y is None else Y.to(dev), **kw)
    on_cpu = sharded_passcode_solve(X, td.Hinge(), y=Y, use_kernel=True,
                                    device="cpu", **kw)
    _close(on_card.alpha, on_cpu.alpha)
    _close(on_card.w_hat, on_cpu.w_hat)
    np.testing.assert_allclose(on_card.gaps.cpu().numpy(),
                               on_cpu.gaps.numpy(), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(on_card.eps.cpu().numpy(),
                               on_cpu.eps.numpy(), rtol=1e-5, atol=ATOL)
    np.testing.assert_array_equal(on_card.delay.cpu().numpy(),
                                  on_cpu.delay.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["1d_ell", "1d_dense", "2d"])
def test_pod1_is_the_plain_mesh_on_the_card(mesh):
    """A (pod = 1) mesh at pod_delay_rounds 0 is the plain mesh on the
    card too: α and ŵ bit for bit.  The gap takes w(α) through
    ``index_add_``, whose atomics add in another order from call to
    call: two evaluations of one α part by up to 2.3e-6 relative on the
    2-D mesh here, so the records are held at rtol 1e-5."""
    from repro_torch.dist.mesh import SolverMesh, solver_mesh, solver_mesh_3d
    dev = _cuda()
    ds = make_dataset("tiny", device="cpu")
    X = (ds.dense_train() if mesh == "1d_dense" else ds.X_train).to(dev)
    plain, pod = ((solver_mesh_2d(data=2, model=2),
                   solver_mesh_3d(pod=1, data=2, model=2)) if mesh == "2d"
                  else (solver_mesh(n_devices=4),
                        SolverMesh(("pod", "data"), (1, 4))))
    kw = dict(epochs=3, block_size=16, seed=3)
    a = sharded_passcode_solve(X, td.Hinge(), mesh=plain, **kw)
    b = sharded_passcode_solve(X, td.Hinge(), mesh=pod, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a.alpha, b.alpha) and torch.equal(a.w_hat, b.w_hat)
    np.testing.assert_allclose(a.gaps.cpu().numpy(), b.gaps.cpu().numpy(),
                               rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["cocoa", "cocoa_pod_ell",
                                    "cocoa_pod_dense", "asyscd"])
def test_baselines_on_the_card_match_cpu_path(solver):
    """CoCoA (B2 over K partitions a round), the pod oracle (B1 or B2
    over P pods an epoch) and AsySCD (torch ops) on the card against
    their CPU paths."""
    from repro_torch.core import asyscd_solve, cocoa_pod_solve, cocoa_solve
    dev = _cuda()
    ds = make_dataset("tiny", device="cpu")
    X = ds.X_train if solver == "cocoa_pod_ell" else ds.dense_train()
    loss = td.SquaredHinge(0.8)
    if solver == "cocoa":
        run = lambda Xs, d: cocoa_solve(Xs, loss, n_partitions=4,  # noqa
                                        outer_rounds=3, seed=2, device=d)
    elif solver == "asyscd":
        run = lambda Xs, d: asyscd_solve(Xs, loss, n_threads=8,  # noqa
                                         epochs=2, seed=2, device=d)
    else:
        run = lambda Xs, d: cocoa_pod_solve(  # noqa
            Xs, loss, n_pods=3, epochs=3, block_size=16,
            pod_delay_rounds=1, seed=2, device=d)
    on_card, on_cpu = run(X.to(dev), dev), run(X, "cpu")
    _close(on_card.alpha, on_cpu.alpha)
    if solver != "asyscd":
        _close(on_card.w, on_cpu.w)
    np.testing.assert_allclose(on_card.gaps.numpy(), on_cpu.gaps.numpy(),
                               rtol=1e-5, atol=1e-4)


SEGMENTED_MESHES = {
    "1d": dict(mesh=solver_mesh(n_devices=2), delay_rounds=1),
    "2d_overlap": dict(mesh=solver_mesh_2d(model=2), delay_rounds=1),
    "pod": dict(mesh=SolverMesh(("pod", "data"), (2, 2)),
                pod_delay_rounds=1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(SEGMENTED_MESHES))
def test_segmented_on_the_card_bit_identical(kind, tmp_path):
    """On the card (B1 on the 1-D and pod meshes, B4 + B5 overlapped on
    the 2-D one): segmented against whole, a resume against the
    uninterrupted run and a NaN fault replayed against the clean run —
    α and ŵ bit for bit; the gaps at rtol 1e-6, as the gap's sum adds
    with float atomics."""
    dev = _cuda()
    X = make_dataset("tiny", device="cpu").X_train.to(dev)
    kw = dict(epochs=4, block_size=16, seed=4, device=dev,
              **SEGMENTED_MESHES[kind])

    def same(a, b):
        assert torch.equal(a.alpha, b.alpha) and torch.equal(a.w_hat,
                                                             b.w_hat)
        np.testing.assert_allclose(a.gaps.cpu().numpy(),
                                   b.gaps.cpu().numpy(), rtol=1e-6, atol=0)

    whole = sharded_passcode_solve(X, td.Hinge(), **kw)
    seg = solve_segmented(X, td.Hinge(), checkpoint_every=1,
                          ckpt_dir=str(tmp_path), keep=10, **kw)
    assert seg.attempts == (1,) * 4 and seg.health == 0
    same(whole, seg.result)
    for s in (2, 3, 4):
        shutil.rmtree(tmp_path / f"ckpt_{s}")
    res = solve_segmented(X, td.Hinge(), checkpoint_every=1, resume=True,
                          ckpt_dir=str(tmp_path), keep=10, **kw)
    assert res.resumed_from == 1 and res.attempts == (1, 1, 1)
    same(whole, res.result)
    fault = solve_segmented(X, td.Hinge(), checkpoint_every=2,
                            fault_plan=FaultPlan(nan_psum_epoch=2), **kw)
    assert fault.attempts == (1, 2) and fault.rollbacks == 1
    same(whole, fault.result)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [0, 4])
def test_serve_engine_on_the_card_matches_cpu(K):
    """The same payloads scored against the same snapshot by an engine on
    the card and one on the CPU: every score and margin at atol 1e-6
    (the gather-and-sum adds its k_max products in another order), the
    labels and the versions equal."""
    from repro_torch.serve import ServeEngine, SnapshotStore, make_snapshot
    dev = _cuda()
    rng = np.random.default_rng(3 + K)
    d, kmax = 300, 9
    w = rng.standard_normal((K, d) if K else d).astype(np.float32)
    pays = [(rng.integers(0, d, size=int(k)),
             rng.standard_normal(int(k)).astype(np.float32))
            for k in rng.integers(1, kmax + 1, size=40)]
    outs = {}
    for where in (dev, "cpu"):
        eng = ServeEngine(SnapshotStore(make_snapshot(w, 1, device=where)),
                          k_max=kmax, max_batch=16, queue_depth=64,
                          default_deadline_s=30.0, device=where)
        tickets = [eng.submit(cols=c, vals=v) for c, v in pays]
        while len(eng.queue):
            eng.step()
        outs[str(where)] = [t.result(1.0) for t in tickets]
    for a, b in zip(outs[str(dev)], outs["cpu"]):
        assert (a.version, a.label) == (b.version, b.label)
        np.testing.assert_allclose(a.score, b.score, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.margins, b.margins, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [0, 3])
def test_trainer_resolve_on_the_card_matches_cpu(K):
    """An ``IncrementalTrainer`` fit and one append-and-resolve on the
    card (B1 over the shard grid, or the task grid) against the same on
    the CPU: α and ŵ at atol 1e-5, the ledgers equal."""
    from repro_torch.serve import IncrementalTrainer
    dev = _cuda()
    X = make_dataset("tiny", device="cpu").X_train
    n0 = X.n_rows - 40
    head = type(X)(X.indices[:n0], X.values[:n0], X.n_features)
    tail = type(X)(X.indices[n0:], X.values[n0:], X.n_features)
    ids = torch.arange(X.n_rows) % 3
    runs = {}
    for where in (dev, "cpu"):
        kw = dict(epochs=3, device=where, solver_kwargs=dict(
            block_size=16, seed=2, mesh=solver_mesh(n_devices=2)))
        if K:
            kw.update(n_classes=K, y0=ids[:n0])
        tr = IncrementalTrainer(head, td.Hinge(), **kw)
        tr.fit()
        tr.add_labeled(tail, ids[n0:] if K else -torch.ones(40))
        assert tr.resolve(epochs=2) is not None
        runs[str(where)] = tr
    a, b = runs[str(dev)], runs["cpu"]
    assert a.ledger == b.ledger
    _close(a.alpha, b.alpha)
    _close(a.w, b.w)


@pytest.mark.cuda
def test_ell_append_on_the_card_matches_cpu():
    """``ell_repack``/``ell_append`` on the card against the CPU, bit for
    bit, with the padding scattered among the entries and a widened
    k_max."""
    from repro_torch.data.sparse import (EllMatrix, ell_append, ell_repack,
                                         ell_row_nnz)
    dev = _cuda()
    rng = np.random.default_rng(8)
    n, k, d = 5000, 24, 1000
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    idx[rng.random((n, k)) < 0.4] = d
    val = np.where(idx < d, rng.standard_normal((n, k)), 0.0).astype(
        np.float32)
    cpu = EllMatrix(torch.from_numpy(idx), torch.from_numpy(val), d)
    card = cpu.to(dev)
    for out_card, out_cpu in (
            (ell_repack(card, k + 3), ell_repack(cpu, k + 3)),
            (ell_append(card, EllMatrix(cpu.indices[:700],
                                        cpu.values[:700], d)),
             ell_append(cpu, EllMatrix(cpu.indices[:700],
                                       cpu.values[:700], d)))):
        assert out_card.indices.device.type == "cuda"
        assert torch.equal(out_card.indices.cpu(), out_cpu.indices)
        assert torch.equal(out_card.values.cpu(), out_cpu.values)
    assert torch.equal(ell_row_nnz(card).cpu(), ell_row_nnz(cpu))
