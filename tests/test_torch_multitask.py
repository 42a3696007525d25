"""The multi-task (one-vs-rest) slice against the reference: K binary
problems on one unfolded X, solved as one solve with a leading task
dimension.

The spine is the reference's own (``tests/test_multitask.py``):

  * K = 1 is bit-identical to the port's binary path on pre-folded rows
    (``assert_array_equal`` on α and ŵ; the gap at rtol 1e-6), for each
    of the reference's ``K1_VARIANTS`` and on the 2-D engines — folding
    ±1 labels on read is an exact sign flip;
  * K = 16 matches the reference's multi-task solve per class at atol
    1e-5 on α, ŵ and ‖w(α) − ŵ‖, the gap at 1e-5 + 1e-6·M
    (``test_torch_solver._gap_atol``, ROADMAP C.2), and the port's own
    loop over K binary solves at atol 1e-5;
  * per-task self-tuning (shrink masks, repacking with each task's round
    count, the adaptive latches) against the reference's multi-task
    solve, its records equal, one host read of the round counts an
    epoch.

Plus the kernels' task grids (the plain versions of B1, B2, B4 and B5
with K = 3 against the reference's Pallas kernels in interpret mode
under ``jax.vmap`` over tasks, atol 1e-5; K = 1 bit-equal to the
task-free call), the labels module, ``predict_multiclass`` /
``multiclass_accuracy``, ``task_axis_policy`` / ``solver_mesh_tasks``
and the label validation against the reference's.  p > 1 data shards
and the ``task`` mesh are in ``test_torch_multitask_shards.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import duals as rd
from repro.core import objective as robj
from repro.core import sharded as rs
from repro.data import labels as rlab
from repro.data import make_dataset
from repro.data.sparse import dense_to_ell as ref_dense_to_ell
from repro.data.sparse import ell_column_split as ref_split
from repro.dist import mesh as rmesh
from repro.kernels import dcd_feature as rfeat
from repro.kernels import ops as rops
from repro_torch.convert import (
    dense_from_numpy,
    ell_from_numpy,
    labels_from_numpy,
    state_from_numpy,
    w2d_from_numpy,
    w2d_to_numpy,
)
from repro_torch.core import duals as td
from repro_torch.core import multiclass_accuracy, predict_multiclass
from repro_torch.core.sharded import prepare_solver, sharded_passcode_solve
from repro_torch.data import (
    MultitaskLabels,
    multitask_labels,
    ovr_decode,
    ovr_labels,
)
from repro_torch.data.sparse import dense_to_ell
from repro_torch.dist import mesh as tmesh
from repro_torch.kernels import dcd_block, dcd_ell, ops
from repro_torch.kernels import dcd_feature as feat

from test_torch_solver import ATOL, _assert_tasks

LOSSES = ["hinge", "squared_hinge", "logistic"]


def _data(n=96, d=20, n_classes=4, seed=0):
    """The reference's law: unfolded dense rows and class ids with a
    planted signal (``tests/test_multitask.py:_data``), as numpy."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    X[np.arange(n), y % d] += 2.0
    return X, y


def _port(X, ell):
    """The rows for the port (dense, or ELL by the port's converter)."""
    Xt = dense_from_numpy(X, device="cpu")
    return dense_to_ell(Xt, device="cpu") if ell else Xt


def _ref(X, ell):
    return ref_dense_to_ell(X) if ell else X


def _bit_eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------ K = 1 bit parity

K1_VARIANTS = {
    "dense": dict(),
    "ell": dict(),
    "delay": dict(delay_rounds=1),
    "shrink": dict(shrink_every=1),
    "adaptive": dict(adaptive=True, delay_rounds=1),
    "fused_ell": dict(use_kernel=True),
}


@pytest.mark.parametrize("variant", sorted(K1_VARIANTS))
def test_k1_bit_identical_1d(variant):
    """A (1, n) label matrix reproduces the port's binary solve on
    pre-folded rows bit for bit: the same update order, and folding ±1
    on read is an IEEE sign flip.  The gap is evaluated task by task, so
    it agrees too (held at rtol 1e-6, as the reference holds its own)."""
    X, y_int = _data(n=64, d=16, n_classes=2)
    y = np.where(y_int == 0, 1.0, -1.0).astype(np.float32)
    kw = dict(epochs=2, block_size=16, device="cpu", **K1_VARIANTS[variant])
    ell = variant != "dense"
    ref = sharded_passcode_solve(_port(X * y[:, None], ell), td.Hinge(C=1.0),
                                 **kw)
    r = sharded_passcode_solve(_port(X, ell), td.Hinge(C=1.0), y=y[None],
                               **kw)
    assert r.alpha.shape == (1, X.shape[0]) and r.w_hat.shape == (1, 16)
    _bit_eq(r.alpha[0], ref.alpha)
    _bit_eq(r.w_hat[0], ref.w_hat)
    np.testing.assert_allclose(r.gaps[0].numpy(), ref.gaps.numpy(),
                               rtol=1e-6)
    for f in ("active", "delay"):
        _bit_eq(getattr(r, f)[0], getattr(ref, f))


@pytest.mark.parametrize("engine", ["unfused", "fused", "overlap"])
def test_k1_bit_identical_2d(engine):
    """The same bit parity on the 2-D engines: the unfused engine, the
    fused B4 → B5 round (plain versions on the CPU) and the overlapped
    round, at m = 2 feature shards."""
    X, y_int = _data(n=64, d=16, n_classes=2)
    y = np.where(y_int == 0, 1.0, -1.0).astype(np.float32)
    kw = dict(mesh=tmesh.solver_mesh_2d(model=2), epochs=2, block_size=16,
              device="cpu", use_kernel=engine != "unfused",
              delay_rounds=int(engine == "overlap"))
    ref = sharded_passcode_solve(_port(X * y[:, None], True),
                                 td.Hinge(C=1.0), **kw)
    r = sharded_passcode_solve(_port(X, True), td.Hinge(C=1.0), y=y[None],
                               **kw)
    _bit_eq(r.alpha[0], ref.alpha)
    _bit_eq(r.w_hat[0], ref.w_hat)
    np.testing.assert_allclose(r.gaps[0].numpy(), ref.gaps.numpy(),
                               rtol=1e-6)


# ------------------------------------------------- K = 16 one solve

@pytest.fixture(scope="module")
def k16():
    K = 16
    X, y_int = _data(n=96, d=20, n_classes=K, seed=1)
    return X, np.asarray(rlab.ovr_labels(y_int, K))


K16 = dict(epochs=3, block_size=16)


@pytest.mark.parametrize("loss", LOSSES)
def test_k16_matches_reference(k16, loss):
    """The acceptance bar: a K = 16 one-vs-rest solve is one solve and
    matches the reference's multi-task solve class by class."""
    X, Y = k16
    r = rs.sharded_passcode_solve(X, rd.make_loss(loss), y=Y, **K16)
    Xp = _port(X, False)
    p = sharded_passcode_solve(Xp, td.make_loss(loss),
                               y=labels_from_numpy(Y, device="cpu"),
                               device="cpu", **K16)
    assert p.alpha.shape == (16, 96) and p.w_hat.shape == (16, 20)
    assert p.gaps.shape == (16, 3)
    _assert_tasks(p, r, Xp, Y, td.make_loss(loss))


@pytest.mark.parametrize("loss", LOSSES)
def test_k16_matches_port_loop(k16, loss):
    """The one solve against the port's loop over K binary solves on
    rows folded by Y[k], at atol 1e-5 per class."""
    X, Y = k16
    lp = td.make_loss(loss)
    p = sharded_passcode_solve(_port(X, True), lp, y=Y, device="cpu",
                               **K16)
    for k in range(Y.shape[0]):
        b = sharded_passcode_solve(_port(X * Y[k][:, None], True), lp,
                                   device="cpu", **K16)
        for got, want in ((p.alpha[k], b.alpha), (p.w_hat[k], b.w_hat),
                          (p.eps[k], b.eps)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=ATOL)


# ------------------------------------------------ per-task self-tuning

TUNING = {
    # the reference's test_multitask_ell_shrink_matches_loop case
    "ell-shrink": (True, dict(shrink_every=1)),
    # each task repacks on its own count: the epoch runs the largest,
    # a task past its own keeps its state
    "ell-repack": (True, dict(shrink_every=1, repack=True,
                              repack_threshold=0.9)),
    "dense-repack-adaptive": (False, dict(shrink_every=1, repack=True,
                                          repack_threshold=0.9,
                                          adaptive=True, delay_rounds=1,
                                          adaptive_ratio=0.5)),
    "dense-adaptive": (False, dict(adaptive=True, delay_rounds=1,
                                   adaptive_ratio=0.5)),
}


@pytest.mark.parametrize("case", sorted(TUNING))
def test_per_task_self_tuning_matches_reference(case):
    """Each class its own shrink mask, repack flag, round count and
    adaptive latch, the epoch counter shared: K = 3 against the
    reference's multi-task solve at p = 1, every record held (α on the
    box at the same rounding, so atol 1e-5 holds throughout here).  The
    tasks' round counts are one host read an epoch."""
    ell, knobs = TUNING[case]
    K = 3
    X, y_int = _data(n=96, d=20, n_classes=K, seed=2)
    Y = np.asarray(rlab.ovr_labels(y_int, K))
    kw = dict(epochs=4, block_size=16, **knobs)
    r = rs.sharded_passcode_solve(_ref(X, ell), rd.Hinge(C=1.0), y=Y, **kw)
    Xp = _port(X, ell)
    reads = sharded_passcode_solve.host_reads
    p = sharded_passcode_solve(Xp, td.Hinge(C=1.0), y=Y, device="cpu", **kw)
    _assert_tasks(p, r, Xp, Y, td.Hinge(C=1.0))
    # shrinking resolves repack "auto" on: one read of the counts an epoch
    want_reads = 4 if knobs.get("shrink_every") else 0
    assert sharded_passcode_solve.host_reads - reads == want_reads
    rounds = sharded_passcode_solve.task_rounds
    assert len(rounds) == 4 and all(len(c) == K for c in rounds)
    assert sharded_passcode_solve.epoch_rounds == [max(c) for c in rounds]


def test_repacked_tasks_run_their_own_round_counts():
    """With repacking, tasks that shrink differently run different round
    counts in one epoch (the case the valid-prefix select exists for),
    and each class still equals its own binary solve."""
    K = 3
    X, y_int = _data(n=96, d=20, n_classes=K, seed=2)
    Y = np.asarray(rlab.ovr_labels(y_int, K))
    kw = dict(epochs=4, block_size=8, shrink_every=1, repack=True,
              repack_threshold=0.95, device="cpu")
    p = sharded_passcode_solve(_port(X, True), td.Hinge(C=1.0), y=Y, **kw)
    assert any(len(set(c)) > 1 for c in sharded_passcode_solve.task_rounds)
    for k in range(K):
        b = sharded_passcode_solve(_port(X * Y[k][:, None], True),
                                   td.Hinge(C=1.0), **kw)
        _bit_eq(p.alpha[k], b.alpha)
        _bit_eq(p.w_hat[k], b.w_hat)


def test_warm_start_stacks_and_blocks():
    """(K, n)/(K, d) warm starts and an explicit ``blocks=`` schedule
    (one for every task) against the reference's."""
    K = 4
    X, y_int = _data(n=64, d=16, n_classes=K, seed=3)
    Y = np.asarray(rlab.ovr_labels(y_int, K))
    rng = np.random.default_rng(3)
    a0 = rng.uniform(0, 0.5, (K, 50)).astype(np.float32)  # shorter than n
    w0 = (rng.standard_normal((K, 16)) * 0.05).astype(np.float32)
    kw = dict(epochs=2, block_size=16, seed=4)
    r = rs.sharded_passcode_solve(X, rd.Hinge(), y=Y, alpha0=a0, w0=w0,
                                  **kw)
    pa0, pw0 = state_from_numpy(a0, w0, device="cpu")
    Xp = _port(X, False)
    p = sharded_passcode_solve(Xp, td.Hinge(), y=Y, alpha0=pa0, w0=pw0,
                               device="cpu", **kw)
    _assert_tasks(p, r, Xp, Y, td.Hinge())
    sched = np.stack([rng.permutation(64).reshape(4, 16) for _ in range(2)])
    q = sharded_passcode_solve(Xp, td.Hinge(), y=Y, blocks=sched,
                               device="cpu", **kw)
    for k in range(K):
        b = sharded_passcode_solve(Xp * torch.tensor(Y[k])[:, None],
                                   td.Hinge(), blocks=sched, device="cpu",
                                   **kw)
        _bit_eq(q.alpha[k], b.alpha)


def test_2d_multitask_matches_reference():
    """The 2-D mesh with K = 4: the unfused engine against the
    reference's (1, 1)-mesh solve, and the fused and overlapped rounds
    at m = 2 against the same (the feature split is invisible)."""
    K = 4
    X, y_int = _data(n=96, d=20, n_classes=K, seed=5)
    Y = np.asarray(rlab.ovr_labels(y_int, K))
    kw = dict(epochs=3, block_size=16, delay_rounds=1)
    r = rs.sharded_passcode_solve(ref_dense_to_ell(X), rd.Hinge(), y=Y,
                                  mesh=jax.make_mesh((1, 1),
                                                     ("data", "model")),
                                  **kw)
    Xp = _port(X, True)
    for m, uk in ((1, "auto"), (2, True)):
        p = sharded_passcode_solve(Xp, td.Hinge(), y=Y,
                                   mesh=tmesh.solver_mesh_2d(model=m),
                                   use_kernel=uk, device="cpu", **kw)
        assert p.w_hat.shape == (K, 20)
        _assert_tasks(p, r, Xp, Y, td.Hinge())


# ------------------------------------------------------ kernel task grids

def _ell_rows(rng, n, d, k):
    cols = np.full((n, k), d, np.int32)
    vals = np.zeros((n, k), np.float32)
    for i in range(n):
        nnz = rng.integers(1, k + 1)
        cols[i, :nnz] = rng.choice(d, nnz, replace=False)
        vals[i, :nnz] = rng.standard_normal(nnz) * 0.4
    return cols, vals


def _task_state(rng, K, n, w_len, shared_act):
    alpha = rng.uniform(0.05, 0.5, (K, n)).astype(np.float32)
    w = (rng.standard_normal((K, w_len)) * 0.1).astype(np.float32)
    act = (rng.random(n if shared_act else (K, n)) > 0.25).astype(
        np.float32)
    y = np.where(rng.random((K, n)) > 0.5, 1.0, -1.0).astype(np.float32)
    return alpha, w, act, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref):
    np.testing.assert_allclose(port.cpu().numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def _vmap_block(fn, alpha, w, act, y, shared_act):
    """The reference's block update vmapped over the tasks' (α, w, act,
    y), the rest closed over: the reference's task vmap."""
    return jax.vmap(lambda a, wv, ac, yv: fn(a, wv, ac, yv),
                    in_axes=(0, 0, None if shared_act else 0, 0))(
        jnp.asarray(alpha), jnp.asarray(w), jnp.asarray(act), jnp.asarray(y))


@pytest.mark.parametrize("shared_ids", [True, False],
                         ids=["shared-ids", "task-ids"])
@pytest.mark.parametrize("kernel", ["B1", "B2"])
@pytest.mark.parametrize("loss", LOSSES)
def test_b1_b2_task_grid_plain_matches_vmapped_pallas(kernel, loss,
                                                      shared_ids):
    """B1's and B2's plain versions over K = 3 tasks of p = 2 shards
    (the tail shard padded) against the reference's Pallas kernel in
    interpret mode, vmapped over the tasks shard by shard."""
    rng = np.random.default_rng(7)
    K, p, n_loc, d, B = 3, 2, 24, 30, 10
    n = p * n_loc
    if kernel == "B1":
        cols, vals = _ell_rows(rng, n, d, 7)
        q, w_len = (vals * vals).sum(1), d + 1
    else:
        X = (rng.standard_normal((n, d)) * 0.2).astype(np.float32)
        q, w_len = (X * X).sum(1), d
    alpha, w, act, y = _task_state(rng, K, n, w_len, shared_act=shared_ids)
    if kernel == "B1":
        w[:, d] = 0.0
    ids = rng.integers(0, n_loc, (K, p, B)).astype(np.int32)
    ids[:, :, 5] = ids[:, :, 2]  # a repeated id
    if shared_ids:
        ids = ids[0]
    lp, lr = td.make_loss(loss, 0.8), rd.make_loss(loss, 0.8)
    if kernel == "B1":
        pa, pdw = ops.dcd_ell_block_update(
            _t(cols), _t(vals), _t(q), _t(alpha), _t(w), _t(ids), loss=lp,
            active=_t(act), y=_t(y), n_loc=n_loc)
    else:
        pa, pdw = ops.dcd_block_update(
            _t(X), _t(q), _t(alpha), _t(w), _t(ids), loss=lp,
            active=_t(act), y=_t(y), n_loc=n_loc)
    assert pdw.shape == (K, p, w_len)
    a_ref = alpha
    for s in range(p):
        gid = (ids[s] if shared_ids else ids[:, s]) + s * n_loc
        if kernel == "B1":
            def fn(a, wv, ac, yv, g):
                return rops.dcd_ell_block_update_pallas(
                    jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(q), a,
                    wv, g, loss=lr, interpret=True, active=ac, y=yv)
        else:
            def fn(a, wv, ac, yv, g):
                return rops.dcd_block_update_pallas(
                    jnp.asarray(X), jnp.asarray(q), a, wv, g, loss=lr,
                    interpret=True, active=ac, y=yv)
        ra, rdw = jax.vmap(fn, in_axes=(0, 0, None if shared_ids else 0, 0,
                                        None if shared_ids else 0))(
            jnp.asarray(a_ref), jnp.asarray(w), jnp.asarray(act),
            jnp.asarray(y), jnp.asarray(gid))
        a_ref = np.asarray(ra)
        _close(pdw[:, s], rdw)
    _close(pa, a_ref)


@pytest.mark.parametrize("kernel", ["B1", "B2"])
def test_b1_b2_task_grid_k1_bit_equal_to_task_free_call(kernel):
    """K = 1 of the task grid is the task-free shard grid, bit for bit
    (α and each shard's Δw)."""
    rng = np.random.default_rng(8)
    p, n_loc, d, B = 3, 16, 20, 8
    n = p * n_loc
    alpha, w, act, y = _task_state(rng, 1, n, d + 1, shared_act=True)
    w[:, d] = 0.0
    ids = _t(rng.integers(0, n_loc, (p, B)).astype(np.int32))
    loss = td.Logistic(0.7)
    if kernel == "B1":
        cols, vals = _ell_rows(rng, n, d, 6)
        q = (vals * vals).sum(1)
        args = (_t(cols), _t(vals))
        fn = dcd_ell.dcd_ell_shards
        ww = w
    else:
        X = (rng.standard_normal((n, d)) * 0.2).astype(np.float32)
        q = (X * X).sum(1)
        args = (_t(X),)
        fn = dcd_block.dcd_indexed_shards
        ww = w[:, :d]
    ka, kdw = fn(*args, _t(alpha), _t(ww), _t(q), loss=loss, idx=ids,
                 n_loc=n_loc, active=_t(act), y=_t(y))
    ba, bdw = fn(*args, _t(alpha[0]), _t(ww[0]), _t(q), loss=loss, idx=ids,
                 n_loc=n_loc, active=_t(act), y=_t(y[0]))
    _bit_eq(ka[0], ba)
    _bit_eq(kdw[0], bdw)


@pytest.fixture(scope="module")
def tiny():
    X = make_dataset("tiny").X_train
    return X, ell_from_numpy(np.asarray(X.indices), np.asarray(X.values),
                             X.n_features, device="cpu")


@pytest.mark.parametrize("shared_ids", [True, False],
                         ids=["shared-ids", "task-ids"])
@pytest.mark.parametrize("loss", LOSSES)
def test_b4_b5_task_grid_plain_matches_vmapped_pallas(tiny, loss,
                                                      shared_ids):
    """B4's and B5's plain versions over K = 3 tasks of m = 2 feature
    shards against the reference's Pallas kernels in interpret mode,
    vmapped over the tasks, model shard by model shard (the base and
    Gram summed over shards with numpy where the reference psums)."""
    X, _ = tiny
    m, K, B = 2, 3, 12
    fse = ref_split(X, m)
    cols, vals = np.asarray(fse.indices), np.asarray(fse.values)
    q = np.asarray(fse.row_sq_norms())
    n, d1 = X.n_rows, fse.d_loc + 1
    rng = np.random.default_rng(9)
    alpha, _, act, y = _task_state(rng, K, n, 1, shared_act=shared_ids)
    w = (rng.standard_normal((K, m, d1)) * 0.05).astype(np.float32)
    w[:, :, -1] = 0.0
    ids = np.stack([rng.permutation(n)[:B] for _ in range(K)]).astype(
        np.int32)
    ids[:, 7] = ids[:, 2]
    idx = ids[:1] if shared_ids else ids[:, None]  # (1, B) or (K, 1, B)
    base_p, gram_p = feat.dcd_feature_gram(_t(cols), _t(vals), _t(w),
                                           _t(idx), tasks=True)
    assert base_p.shape == (K, 1, m, B) and gram_p.shape == (K, 1, m, B, B)
    g_in = None if shared_ids else 0
    parts = [jax.vmap(lambda wv, g, j=j: rfeat.dcd_feature_gram_pallas_call(
        jnp.asarray(cols[:, j]), jnp.asarray(vals[:, j]), wv, g,
        interpret=True), in_axes=(0, g_in))(
        jnp.asarray(w[:, j]), jnp.asarray(idx.reshape(-1, B)[0]
                                          if shared_ids else ids))
        for j in range(m)]
    for j in range(m):
        _close(base_p[:, 0, j], parts[j][0])
        _close(gram_p[:, 0, j], parts[j][1])
    base = np.sum([np.asarray(b) for b, _ in parts], axis=0)  # (K, B)
    gram = np.sum([np.asarray(g) for _, g in parts], axis=0)
    lp, lr = td.make_loss(loss, 0.8), rd.make_loss(loss, 0.8)
    pa, pw = feat.dcd_feature_update(
        _t(cols), _t(vals), _t(alpha), _t(q), _t(w), _t(idx),
        _t(base[:, None]), _t(gram[:, None]), loss=lp, active=_t(act),
        y=_t(y))
    assert pw.shape == (K, 1, m, d1)
    for j in range(m):
        ra, rw = jax.vmap(
            lambda a, wv, g, b, gm, ac, yv, j=j:
            rfeat.dcd_feature_update_pallas_call(
                jnp.asarray(cols[:, j]), jnp.asarray(vals[:, j]), a,
                jnp.asarray(q), wv, g, b, gm, loss=lr, interpret=True,
                active=ac, y=yv),
            in_axes=(0, 0, g_in, 0, 0, None if shared_ids else 0, 0))(
            jnp.asarray(alpha), jnp.asarray(w[:, j]),
            jnp.asarray(ids[0] if shared_ids else ids), jnp.asarray(base),
            jnp.asarray(gram), jnp.asarray(act), jnp.asarray(y))
        _close(pa, ra)
        _close(pw[:, 0, j], rw)


def test_b4_b5_task_grid_k1_bit_equal_to_task_free_call(tiny):
    """K = 1 of B4's and B5's task grids is the task-free call over the
    same p = 2 data shards, bit for bit."""
    X, Xp = tiny
    m, p, B = 2, 2, 8
    fse = ref_split(X, m)
    cols, vals = _t(np.asarray(fse.indices)), _t(np.asarray(fse.values))
    q = _t(np.asarray(fse.row_sq_norms()))
    n, n_loc, d1 = X.n_rows, X.n_rows // p, fse.d_loc + 1
    rng = np.random.default_rng(10)
    w = _t((rng.standard_normal((p, m, d1)) * 0.05).astype(np.float32))
    w[..., -1] = 0.0
    alpha = _t(rng.uniform(0.05, 0.5, n).astype(np.float32))
    y = _t(np.where(rng.random(n) > 0.5, 1.0, -1.0).astype(np.float32))
    idx = _t(rng.integers(0, n_loc, (p, B)).astype(np.int32))
    kb, kg = feat.dcd_feature_gram(cols, vals, w[None], idx, n_loc=n_loc,
                                   tasks=True)
    bb, bg = feat.dcd_feature_gram(cols, vals, w, idx, n_loc=n_loc)
    _bit_eq(kb[0], bb)
    _bit_eq(kg[0], bg)
    base, gram = bb.sum(-2), bg.sum(-3)
    loss = td.SquaredHinge(0.9)
    ka, kw = feat.dcd_feature_update(cols, vals, alpha[None], q, w[None],
                                     idx, base[None], gram[None], loss=loss,
                                     y=y[None], n_loc=n_loc)
    ba, bw = feat.dcd_feature_update(cols, vals, alpha, q, w, idx, base,
                                     gram, loss=loss, y=y, n_loc=n_loc)
    _bit_eq(ka[0], ba)
    _bit_eq(kw[0], bw)


# ------------------------------------------------------------ small modules

@given(ids=st.lists(st.integers(0, 9), min_size=1, max_size=64))
@settings(max_examples=30, deadline=None)
def test_ovr_roundtrip_bit_equal_to_reference(ids):
    """``ovr_labels`` is the reference's matrix bit for bit, and
    ``ovr_decode`` inverts it as the reference's does."""
    K = max(ids) + 1
    Y = ovr_labels(np.asarray(ids), K, device="cpu")
    R = np.asarray(rlab.ovr_labels(np.asarray(ids), K))
    _bit_eq(Y, R)
    assert Y.dtype == torch.float32 and tuple(Y.shape) == (K, len(ids))
    dec = ovr_decode(Y)
    assert dec.dtype == torch.int32
    _bit_eq(dec, rlab.ovr_decode(R))
    _bit_eq(dec, np.asarray(ids, np.int32))


@pytest.mark.parametrize("bad", [
    dict(y_int=[0, 3], n_classes=3), dict(y_int=[-1, 0], n_classes=2),
    dict(y_int=[0.5, 1.0]), dict(y_int=np.zeros((2, 2), np.int32)),
    dict(y_int=np.asarray([], np.int32)), dict(y_int=[0, 1], n_classes=0)],
    ids=["above", "negative", "fraction", "2-D", "empty", "no-classes"])
def test_ovr_labels_raise_as_the_reference(bad):
    with pytest.raises(ValueError) as want:
        rlab.ovr_labels(**bad)
    with pytest.raises(ValueError) as got:
        ovr_labels(**bad, device="cpu")
    assert str(got.value) == str(want.value)


def test_multitask_labels_and_decode_of_a_tensor():
    mt = multitask_labels([0, 1, 2, 1], device="cpu")
    assert isinstance(mt, MultitaskLabels)
    assert mt.n_classes == 3 and mt.n_rows == 4
    _bit_eq(ovr_decode(mt.y), [0, 1, 2, 1])
    _bit_eq(ovr_labels(torch.tensor([2, 0]), device="cpu"),
            rlab.ovr_labels(np.asarray([2, 0])))
    with pytest.raises(ValueError):
        ovr_decode(torch.ones(3))


@pytest.mark.parametrize("ell", [False, True], ids=["dense", "ell"])
@pytest.mark.parametrize("pad", [False, True], ids=["d", "d+1"])
def test_predict_multiclass_matches_reference(ell, pad):
    """Argmax ids and top-1 accuracy of a (K, d) stack (or (K, d + 1)
    heads with a zero dummy slot) over unfolded rows, as the
    reference's (which takes the (K, d) stack): the ids bit-equal, the
    accuracy to one float32 rounding."""
    X, y_int = _data(n=80, d=12, n_classes=5, seed=6)
    rng = np.random.default_rng(6)
    W = rng.standard_normal((5, 12)).astype(np.float32)
    want = np.asarray(robj.predict_multiclass(W, _ref(X, ell)))
    acc = float(robj.multiclass_accuracy(W, _ref(X, ell), y_int))
    Wp = np.concatenate([W, np.zeros((5, 1), np.float32)], 1) if pad else W
    got = predict_multiclass(torch.from_numpy(Wp), _port(X, ell))
    assert got.dtype == torch.int32
    _bit_eq(got, want)
    # the reference's mean multiplies by 1/n; the port's quotient is the
    # correctly rounded one (21/80: 0.26250002 against 0.26249999)
    assert float(multiclass_accuracy(Wp, _port(X, ell), y_int)) == \
        pytest.approx(acc, rel=2.0 ** -23, abs=0)
    with pytest.raises(ValueError):
        predict_multiclass(torch.from_numpy(W[0]), _port(X, ell))


def test_predict_multiclass_units():
    W = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, -1.0]])
    X = torch.tensor([[2.0, 0.1], [0.1, 2.0], [-3.0, -3.0]])
    _bit_eq(predict_multiclass(W, X), [0, 1, 2])
    assert float(multiclass_accuracy(W, X, [0, 1, 2])) == 1.0
    assert float(multiclass_accuracy(W, X, [0, 1, 0])) == pytest.approx(
        2.0 / 3.0)


TASK_POLICY = [
    (0, ("data",), (1,), True),
    (4, ("data",), (1,), False),
    (3, ("task", "data"), (2, 1), True),
    (4, ("task", "pod", "data"), (1, 1, 1), True),
    (4, ("data",), (1,), True),
    (4, ("task", "data"), (2, 1), True),
    (6, ("task", "data", "model"), (3, 1, 1), True),
]


@pytest.mark.parametrize("K,axes,sizes,pipeline", TASK_POLICY)
def test_task_axis_policy_matches_reference(K, axes, sizes, pipeline):
    """``task_axis_policy`` admits what the reference admits and raises
    its ``ValueError`` word for word (a mesh of the reference's axes and
    sizes on fake devices is not needed: the rule reads names and sizes
    only)."""
    class _M:
        axis_names, shape = axes, dict(zip(axes, sizes))

    mesh = tmesh.SolverMesh(axes, sizes)
    try:
        want = rmesh.task_axis_policy(K, mesh=_M(), pipeline=pipeline)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.task_axis_policy(K, mesh=mesh, pipeline=pipeline)
        assert str(got.value) == str(e)
        return
    assert tmesh.task_axis_policy(K, mesh=mesh, pipeline=pipeline) == want


def test_solver_mesh_tasks_axes():
    assert tmesh.solver_mesh_tasks(task=2, data=4).shape == {"task": 2,
                                                            "data": 4}
    assert tmesh.solver_mesh_tasks(task=2, model=2).shape == {
        "task": 2, "data": 1, "model": 2}
    assert tmesh.solver_mesh_tasks(task=2, n_devices=8).shape == {
        "task": 2, "data": 4}
    assert tmesh.solver_mesh_tasks(4).axis_names == ("task", "data")
    with pytest.raises(ValueError):
        tmesh.solver_mesh_tasks(task=0)


MOUTH = {
    "value": lambda Y: Y.__setitem__((0, 0), 0.5),
    "nan": lambda Y: Y.__setitem__((1, 2), np.nan),
}


@pytest.mark.parametrize("kind", ["value", "nan", "columns", "pipeline",
                                  "task-without-y", "uneven-task"])
def test_label_validation_raises_as_the_reference(kind):
    """The multi-task mouth and the task axis raise where the
    reference's do, with the reference's message (the port names its
    own module where the reference names ``repro.data.ovr_labels`` or
    ``repro.dist.mesh``)."""
    X, y_int = _data(n=32, d=8, n_classes=2)
    Y = np.asarray(rlab.ovr_labels(y_int, 2)).copy()
    kw = dict(epochs=1)
    if kind in MOUTH:
        MOUTH[kind](Y)
    elif kind == "columns":
        Y = np.ones((2, 31), np.float32)
    elif kind == "pipeline":
        kw["pipeline"] = False
    elif kind == "task-without-y":
        Y = None
        kw["mesh"] = "task"
    else:
        Y = np.asarray(rlab.ovr_labels(np.arange(32) % 3, 3))
        kw["mesh"] = "task"
    rkw, pkw = dict(kw), dict(kw, device="cpu")
    if kw.get("mesh") == "task":
        rkw["mesh"] = jax.make_mesh((1, 1), ("task", "data"))
        pkw["mesh"] = tmesh.SolverMesh(("task", "data"), (2, 1))
        if kind == "task-without-y":
            pkw["mesh"] = tmesh.solver_mesh_tasks(task=1)
        else:  # the reference on one device cannot hold task = 2
            rkw = None
    if rkw is not None:
        with pytest.raises(ValueError) as want:
            rs.sharded_passcode_solve(X, rd.Hinge(), y=Y, **rkw)
    with pytest.raises(ValueError) as got:
        sharded_passcode_solve(torch.from_numpy(X), td.Hinge(), y=Y, **pkw)
    if rkw is not None:
        assert (str(got.value).replace("repro_torch.", "repro.")
                == str(want.value))
    else:
        assert "does not divide over the task mesh axis" in str(got.value)


def test_prepare_solver_places_labels():
    """``prepare_solver(y=Y)`` pads the label matrix to the row layout
    with +1 (p = 3 ∤ n = 32) and keeps the tasks' count."""
    X, y_int = _data(n=32, d=8, n_classes=3)
    Y = ovr_labels(y_int, 3, device="cpu")
    setup = prepare_solver(torch.from_numpy(X), td.Hinge(), y=Y,
                           mesh=tmesh.solver_mesh(n_devices=3), device="cpu")
    assert setup.n_tasks == 3 and setup.K == 3
    assert tuple(setup.Y.shape) == (3, 33)
    _bit_eq(setup.Y[:, :32], Y)
    assert bool((setup.Y[:, 32:] == 1.0).all())
    binary = prepare_solver(torch.from_numpy(X), td.Hinge(), device="cpu")
    assert binary.n_tasks == 0 and binary.K == 1 and binary.Y is None


def test_w2d_converters_carry_task_stacks():
    rng = np.random.default_rng(11)
    flat = rng.standard_normal((3, 2 * 6)).astype(np.float32)
    flat.reshape(3, 2, 6)[:, :, 4:] = 0.0  # dummy slot and lane padding
    w = w2d_from_numpy(flat, 2, 4, device="cpu")
    assert tuple(w.shape) == (3, 2, 5)
    _bit_eq(w2d_to_numpy(w, 6), flat)
    _bit_eq(w2d_to_numpy(w[1], 6), flat[1])
