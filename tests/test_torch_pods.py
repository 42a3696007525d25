"""Pods (the Hybrid-DCA outer round) against the reference: the row
layout, the admission policy, the pod solve on the 1-D and 2-D meshes,
``cocoa_pod_solve`` and the pod grid's plain versions.

Spine, on ``tiny`` (102 rows where the reference's own pod tests use
them: n % P and n % p tails are live):

* the layout — ``pod_row_layout``, ``ell_row_partition`` and
  ``PodShardedEll`` equal the reference's, with a round trip over
  random shapes;
* the policy — ``pod_merge_policy`` and ``solver_mesh_3d`` raise and
  return what the reference's do, message for message;
* P = 1 is the plain mesh — a (pod = 1, data = p) mesh at
  ``pod_delay_rounds`` 0 gives the plain mesh's α, ŵ and records bit for
  bit, on 1-D dense, 1-D ELL and 2-D;
* the oracle — at data = 1 the port's pod solve is held to the
  reference's ``cocoa_pod_solve``, and the port's ``cocoa_pod_solve`` to
  the reference's, segmented replay included (chained ``flush=False``
  segments give the whole solve bit for bit, and each segment matches
  the reference's segment fed the same carry);
* the reference's SPMD pod solve, in the child of
  ``test_torch_shards.reference_solves`` (8 fake CPU devices; its
  ``_finalize`` fetched to the host, ROADMAP C.9): (pod, data) meshes of
  (2, 1), (2, 2), (2, 2) with m = 2 and (4, 2) with an n % p tail, at
  ``pod_delay_rounds`` 0 and 1, the pod ``adaptive`` latch, and a (3, n)
  label matrix;
* staleness — mean ε grows with ``pod_delay_rounds`` ∈ {0, 1, 2, 4} and
  is float noise at 0; a warm start carried onto another pod count.

Tolerances: the spine's atol 1e-5 on α, ŵ and ε; the gaps at
1e-5 + 1e-6·M (``test_torch_solver._gap_atol``); flags equal.
"""

import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import cocoa as rc
from repro.core import duals as rd
from repro.core import sharded as rs
from repro.data import make_dataset
from repro.data import sparse as rsp
from repro.dist import mesh as rm
from repro_torch.convert import (
    dense_from_numpy,
    ell_from_numpy,
    fifo_from_numpy,
    key_from_numpy,
    labels_from_numpy,
    pod_sharded_from_numpy,
    state_from_numpy,
)
from repro_torch.core import cocoa_pod_solve
from repro_torch.core import duals as td
from repro_torch.core import sharded as ts
from repro_torch.data import sparse as tsp
from repro_torch.dist import mesh as tm
from repro_torch.kernels import dcd_feature as feat
from repro_torch.kernels import ops
from repro_torch.kernels.dcd_block import dcd_indexed_shards_plain
from repro_torch.kernels.dcd_ell import dcd_ell_shards, dcd_ell_shards_plain

from test_torch_shards import case, finalize_on_host, reference_solves
from test_torch_solver import ATOL, _assert_result, _assert_tasks, _gap_atol

LOSSES = ("hinge", "squared_hinge", "logistic")
ROWS, EPOCHS, B = 102, 5, 16


@pytest.fixture(scope="module")
def tiny():
    X = make_dataset("tiny").X_train
    return (np.array(X.indices), np.array(X.values), X.n_features,
            np.array(X.to_dense()))


def _X(tiny, rows=ROWS, ell=False):
    idx, val, d, dense = tiny
    if ell:
        return ell_from_numpy(idx[:rows], val[:rows], d, device="cpu")
    return dense_from_numpy(dense[:rows], device="cpu")


def _ref_X(tiny, rows=ROWS, ell=False):
    idx, val, d, dense = tiny
    if ell:
        return rsp.EllMatrix(idx[:rows], val[:rows], d)
    return dense[:rows]


def _pod_mesh(P, p=1, model=None):
    if model is None:
        return tm.SolverMesh(("pod", "data"), (P, p))
    return tm.solver_mesh_3d(pod=P, data=p, model=model)


def _ns(r, w="w"):
    """A reference result as numpy fields named as the port's."""
    return types.SimpleNamespace(alpha=np.asarray(r.alpha),
                                 w_hat=np.asarray(getattr(r, w)),
                                 gaps=np.asarray(r.gaps),
                                 eps=np.asarray(r.eps))


def _assert_oracle(p, r, Xp, loss):
    """A pod solve against ``cocoa_pod_solve``: α, ŵ and ε at atol 1e-5,
    the gaps at 1e-5 + 1e-6·M."""
    np.testing.assert_allclose(p.alpha.numpy(), r.alpha, rtol=0, atol=ATOL)
    np.testing.assert_allclose(p.w_hat.numpy(), r.w_hat, rtol=0, atol=ATOL)
    np.testing.assert_allclose(p.eps.numpy(), r.eps, rtol=0, atol=ATOL)
    np.testing.assert_allclose(p.gaps.numpy(), r.gaps, rtol=0,
                               atol=_gap_atol(Xp, p.alpha, loss))


# ------------------------------------------------------------- layout


@pytest.mark.parametrize("n,pods,per", [(10, 3, None), (10, 3, 6),
                                        (102, 2, 52), (3, 4, None),
                                        (1, 1, 2), (250, 4, 64)])
def test_pod_row_layout_matches_reference(n, pods, per):
    rowmap, mask = tsp.pod_row_layout(n, pods, per)
    want_map, want_mask = rsp.pod_row_layout(n, pods, per)
    np.testing.assert_array_equal(rowmap, want_map)
    np.testing.assert_array_equal(mask, want_mask)


def test_pod_row_layout_rejects_lossy():
    for args in ((10, 2, 4), (10, 0)):
        with pytest.raises(ValueError) as want:
            rsp.pod_row_layout(*args)
        with pytest.raises(ValueError) as got:
            tsp.pod_row_layout(*args)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("pods,per", [(2, None), (3, 40), (5, None)])
def test_ell_row_partition_matches_reference(tiny, pods, per):
    idx, val, d, _ = tiny
    ref = rsp.ell_row_partition(rsp.EllMatrix(idx[:ROWS], val[:ROWS], d),
                                pods, per)
    got = tsp.ell_row_partition(_X(tiny, ell=True), pods, per)
    assert (got.n_pods, got.rows_per_pod, got.k_max, got.n_rows,
            got.n_features) == (ref.n_pods, ref.rows_per_pod, ref.k_max,
                                ref.n_rows, ref.n_features)
    for a, b in [(got.indices, ref.indices), (got.values, ref.values),
                 (got.row_mask, ref.row_mask)]:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got.row_sq_norms().numpy(),
                               np.asarray(ref.row_sq_norms()), rtol=1e-6)
    back, want = got.to_ell(), ref.to_ell()
    np.testing.assert_array_equal(back.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(back.values.numpy(),
                                  np.asarray(want.values))
    # the reference's partition carried across is the same layout
    carried = pod_sharded_from_numpy(ref.indices, ref.values, ref.row_mask,
                                     ref.n_features, ref.n_rows,
                                     device="cpu")
    assert torch.equal(carried.to_ell().values, back.values)


@st.composite
def ragged_matrix_and_pods(draw):
    n = draw(st.integers(min_value=1, max_value=12))
    d = draw(st.integers(min_value=1, max_value=30))
    pods = draw(st.integers(min_value=1, max_value=6))
    rng = np.random.default_rng(draw(st.integers(min_value=0,
                                                 max_value=2**31 - 1)))
    dense = rng.standard_normal((n, d)).astype(np.float32)
    keep = rng.random((n, 1)) * rng.random((n, d))
    return np.where(keep > 0.5, dense, 0.0).astype(np.float32), pods


@given(case=ragged_matrix_and_pods())
@settings(max_examples=30, deadline=None)
def test_pod_row_partition_round_trip(case):
    """The port's twin of the reference's round trip: the masks cover
    the real rows once each, padding slots are all-padding rows with
    q = 1, and the pods reassemble the matrix exactly."""
    dense, pods = case
    n, d = dense.shape
    ell = tsp.dense_to_ell(dense, device="cpu")
    pse = tsp.ell_row_partition(ell, pods)
    assert pse.n_pods == pods and pse.n_rows == n
    assert pse.rows_per_pod >= -(-n // pods)
    rowmap, mask = tsp.pod_row_layout(n, pods, pse.rows_per_pod)
    assert mask.sum() == n
    assert np.array_equal(np.sort(rowmap[mask]), np.arange(n))
    assert np.array_equal(pse.row_mask.numpy(), mask)
    idx, val = pse.indices.numpy(), pse.values.numpy()
    assert np.all(idx[~mask] == d) and np.all(val[~mask] == 0.0)
    np.testing.assert_array_equal(pse.to_ell().to_dense().numpy(), dense)
    sq = pse.row_sq_norms().numpy()
    np.testing.assert_allclose(sq[mask], (dense * dense).sum(1)[rowmap[mask]],
                               rtol=1e-6)
    assert np.all(sq[~mask] == 1.0)


@pytest.mark.parametrize("n,pods,p", [(102, 2, 4), (102, 2, 1), (250, 4, 2),
                                      (3, 4, 1), (677, 2, 4)])
def test_solver_layout_is_the_rowmap_gather(n, pods, p):
    """The solver's placement of the rows equals a gather through the
    reference's flattened rowmap (sentinel n → a padding row), and its
    real-row runs invert it."""
    n_loc = -(-max(-(-n // pods), 1) // p)
    segs = ts._pod_segments(n, pods, p, n_loc)
    rowmap, _ = rsp.pod_row_layout(n, pods, per_pod_rows=p * n_loc)
    t = torch.arange(n, dtype=torch.float32) + 1.0
    placed = ts._place_rows(t, pods * p * n_loc, segs, 0.0)
    want = np.concatenate([np.arange(n) + 1.0, [0.0]])[rowmap.reshape(-1)]
    np.testing.assert_array_equal(placed.numpy(), want)
    assert torch.equal(ts._real_rows(placed, segs), t)


# ------------------------------------------------------------- policy

POLICY = [dict(pod_delay_rounds=2, n_pods=2),
          dict(pod_delay_rounds=-1, n_pods=2),
          dict(pod_delay_rounds=1, n_pods=0),
          dict(pod_delay_rounds=1, n_pods=2, pipeline=False),
          dict(pod_delay_rounds=1, n_pods=2, shrink_every=2),
          dict(pod_delay_rounds=1, n_pods=2, overlap=True),
          dict(pod_delay_rounds=1, n_pods=2, adaptive=True, record=False),
          dict(pod_delay_rounds=0, n_pods=3, adaptive=True,
               overlap="auto")]


@pytest.mark.parametrize("kw", POLICY, ids=range(len(POLICY)))
def test_pod_merge_policy_matches_reference(kw):
    kw = dict(kw)
    k = kw.pop("pod_delay_rounds")
    try:
        want = rm.pod_merge_policy(k, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tm.pod_merge_policy(k, **kw)
        assert str(got.value) == str(e)
        return
    assert tm.pod_merge_policy(k, **kw) == want


def test_solver_mesh_3d_shapes():
    mesh = tm.solver_mesh_3d(pod=1, data=1, model=1, n_devices=1)
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh.shape["pod"] == 1
    mesh = tm.solver_mesh_3d(pod=2, model=2, n_devices=8)
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
    assert tm.dp_size(mesh) == 4 and tm.data_axes(mesh) == ("pod", "data")
    with pytest.raises(ValueError):
        tm.solver_mesh_3d(pod=0)


@pytest.mark.parametrize("knob", [dict(pipeline=False),
                                  dict(shrink_every=1),
                                  dict(overlap=True),
                                  dict(adaptive=True, record=False)],
                         ids=["pipeline_false", "shrinking", "overlap",
                              "adaptive_unrecorded"])
def test_pod_mesh_rejects_what_the_reference_rejects(tiny, knob):
    """The solver's mouth on a pod mesh raises the reference's
    ``ValueError`` (``pod_merge_policy``), message for message."""
    X = _ref_X(tiny)
    with pytest.raises(ValueError) as want:
        rs.sharded_passcode_solve(X, rd.Hinge(), epochs=1, **knob,
                                  mesh=jax.make_mesh((1, 1),
                                                     ("pod", "data")))
    with pytest.raises(ValueError) as got:
        ts.sharded_passcode_solve(_X(tiny), td.Hinge(), epochs=1,
                                  device="cpu", mesh=_pod_mesh(1), **knob)
    assert str(got.value) == str(want.value)


def test_pod_delay_needs_a_pod_axis(tiny):
    with pytest.raises(ValueError) as want:
        rs.sharded_passcode_solve(_ref_X(tiny), rd.Hinge(), epochs=1,
                                  pod_delay_rounds=1)
    with pytest.raises(ValueError) as got:
        ts.sharded_passcode_solve(_X(tiny), td.Hinge(), epochs=1,
                                  pod_delay_rounds=1, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="pod"):
        tm.task_axis_policy(4, mesh=tm.SolverMesh(("task", "pod", "data"),
                                                  (2, 1, 1)))


# ------------------------------------------- P = 1 is the plain mesh


@pytest.mark.parametrize("mesh", ["1d_dense", "1d_ell", "2d"])
@pytest.mark.parametrize("loss", LOSSES)
def test_pod1_is_the_plain_mesh_bit_for_bit(tiny, mesh, loss):
    X = _X(tiny, rows=250, ell=mesh != "1d_dense")
    plain, pod = ((tm.solver_mesh_2d(data=2, model=2),
                   _pod_mesh(1, 2, model=2)) if mesh == "2d"
                  else (tm.solver_mesh(n_devices=4), _pod_mesh(1, 4)))
    kw = dict(epochs=3, block_size=B, seed=3, device="cpu")
    a = ts.sharded_passcode_solve(X, td.make_loss(loss), mesh=plain, **kw)
    b = ts.sharded_passcode_solve(X, td.make_loss(loss), mesh=pod, **kw)
    for f in ("alpha", "w_hat", "gaps", "eps", "active", "delay"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ------------------------------------------ against cocoa_pod_solve


ORACLE = [(loss, delay, mesh) for loss in LOSSES for delay in (0, 1, 2)
          for mesh in ("1d", "2d")]


@pytest.fixture(scope="module")
def oracle(tiny):
    """The reference's ``cocoa_pod_solve`` at P = 2 for every (loss,
    delay) of ``ORACLE``, once."""
    X = _ref_X(tiny)
    return {(loss, d): _ns(rc.cocoa_pod_solve(
        X, rd.make_loss(loss), n_pods=2, epochs=EPOCHS, block_size=B,
        pod_delay_rounds=d, seed=0)) for loss in LOSSES for d in (0, 1, 2)}


@pytest.mark.parametrize("loss,delay,mesh", ORACLE)
def test_pod_solve_matches_cocoa_pod_solve(tiny, oracle, loss, delay, mesh):
    """The pod solve at (pod = 2, data = 1) — 1-D dense, or 2-D with
    m = 2 — against the reference's serial oracle."""
    Xp = _X(tiny)
    r = ts.sharded_passcode_solve(
        Xp, td.make_loss(loss), mesh=_pod_mesh(2, model=2 if mesh == "2d"
                                               else None),
        epochs=EPOCHS, block_size=B, pod_delay_rounds=delay, seed=0,
        device="cpu")
    _assert_oracle(r, oracle[(loss, delay)], Xp, td.make_loss(loss))
    assert r.delay.tolist() == [float(delay > 0)] * EPOCHS


@pytest.mark.parametrize("ell", [False, True], ids=["dense", "ell"])
@pytest.mark.parametrize("loss,delay", [(loss, d) for loss in LOSSES
                                        for d in (0, 1, 2)])
def test_cocoa_pod_solve_matches_reference(tiny, oracle, loss, delay, ell):
    """The port's oracle (B1 or B2 over the pods' local epochs) against
    the reference's (dense math)."""
    Xp = _X(tiny, ell=ell)
    r = cocoa_pod_solve(Xp, td.make_loss(loss), n_pods=2, epochs=EPOCHS,
                        block_size=B, pod_delay_rounds=delay, seed=0,
                        device="cpu")
    p = types.SimpleNamespace(alpha=r.alpha, w_hat=r.w, gaps=r.gaps,
                              eps=r.eps)
    _assert_oracle(p, oracle[(loss, delay)], Xp, td.make_loss(loss))
    assert r.rounds == EPOCHS and r.fifo is None


@pytest.mark.parametrize("pods,delay", [(2, 2), (3, 1), (4, 0)])
def test_cocoa_pod_segments_replay_the_whole_solve(tiny, pods, delay):
    """Chained ``flush=False`` segments of the port's oracle give the
    whole solve bit for bit; each segment matches the reference's
    segment fed the same carried (α, w, FIFO, key) at atol 1e-5."""
    Xp, X = _X(tiny), _ref_X(tiny)
    loss, kw = td.SquaredHinge(), dict(n_pods=pods, block_size=B,
                                       pod_delay_rounds=delay, seed=4,
                                       gap_every=2)
    whole = cocoa_pod_solve(Xp, loss, epochs=6, device="cpu", **kw)
    a = cocoa_pod_solve(Xp, loss, epochs=4, total_epochs=6, flush=False,
                        device="cpu", **kw)
    ra = rc.cocoa_pod_solve(X, rd.SquaredHinge(), epochs=4, total_epochs=6,
                            flush=False, **kw)
    b = cocoa_pod_solve(Xp, loss, epochs=2, epoch_start=4, total_epochs=6,
                        alpha0=a.alpha, w0=a.w, fifo0=a.fifo, key0=a.key,
                        device="cpu", **kw)
    assert torch.equal(b.alpha, whole.alpha) and torch.equal(b.w, whole.w)
    assert torch.equal(torch.cat([a.gaps, b.gaps]), whole.gaps)
    assert torch.equal(a.key, key_from_numpy(ra.key, device="cpu"))
    for g, rg in zip(a.fifo, ra.fifo):
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=0,
                                   atol=ATOL)
    # the reference's second segment from the reference's own carry, and
    # the port's from that same carry, carried across
    rb = rc.cocoa_pod_solve(X, rd.SquaredHinge(), epochs=2, epoch_start=4,
                            total_epochs=6, alpha0=ra.alpha, w0=ra.w,
                            fifo0=ra.fifo, key0=ra.key, **kw)
    a0, w0 = state_from_numpy(np.asarray(ra.alpha), np.asarray(ra.w),
                              device="cpu")
    pb = cocoa_pod_solve(Xp, loss, epochs=2, epoch_start=4, total_epochs=6,
                         alpha0=a0, w0=w0,
                         fifo0=fifo_from_numpy(ra.fifo, device="cpu"),
                         key0=key_from_numpy(ra.key, device="cpu"),
                         device="cpu", **kw)
    _assert_oracle(types.SimpleNamespace(alpha=pb.alpha, w_hat=pb.w,
                                         gaps=pb.gaps, eps=pb.eps),
                   _ns(rb), Xp, loss)


def test_cocoa_pod_solve_rejects_what_the_reference_rejects(tiny):
    for kw in (dict(n_pods=0), dict(pod_delay_rounds=-1),
               dict(pod_delay_rounds=2, fifo0=[np.zeros(30, np.float32)])):
        with pytest.raises(ValueError) as want:
            rc.cocoa_pod_solve(_ref_X(tiny), rd.Hinge(), epochs=1, **kw)
        with pytest.raises(ValueError) as got:
            cocoa_pod_solve(_X(tiny), td.Hinge(), epochs=1, device="cpu",
                            **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------- against the reference's SPMD pods

_Y3 = (np.stack([np.arange(250) % 3 == k for k in range(3)]) * 2.0
       - 1.0).tolist()
SPMD = {
    "p2x1-d0": case(rows=ROWS, dense=True, pods=2, p=1, epochs=4,
                    block_size=B, pod_delay_rounds=0, seed=0),
    "p2x1-ell-d1-logistic": case(rows=ROWS, loss="logistic", pods=2, p=1,
                                 epochs=4, block_size=B, pod_delay_rounds=1,
                                 seed=0),
    "p2x2-d0-squared_hinge": case(rows=ROWS, dense=True,
                                  loss="squared_hinge", pods=2, p=2,
                                  epochs=4, block_size=B, seed=1),
    "p2x2-ell-d1": case(rows=ROWS, pods=2, p=2, epochs=4, block_size=B,
                        pod_delay_rounds=1, delay_rounds=1, seed=1),
    "p2x2m2-d1": case(rows=ROWS, pods=2, p=2, model=2, epochs=3,
                      block_size=B, pod_delay_rounds=1, seed=2),
    "p2x2m2-d0-logistic": case(rows=ROWS, loss="logistic", pods=2, p=2,
                               model=2, epochs=3, block_size=B, seed=2),
    "p4x2-tail-d0": case(rows=250, pods=4, p=2, epochs=3, block_size=B,
                         seed=3),
    "p4x2-tail-d1": case(rows=250, dense=True, pods=4, p=2, epochs=3,
                         block_size=B, pod_delay_rounds=1, seed=3),
    "p2x2-adaptive": case(rows=250, loss="squared_hinge", pods=2, p=2,
                          epochs=6, block_size=B, pod_delay_rounds=2,
                          adaptive=True, adaptive_ratio=0.5, seed=4),
    "p2x2-tasks": case(rows=250, pods=2, p=2, Y=_Y3, epochs=3, block_size=B,
                       pod_delay_rounds=1, seed=5),
}


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    return reference_solves(SPMD, tmp_path_factory.mktemp("ref_pods"))


@pytest.mark.parametrize("name", list(SPMD))
def test_pod_solve_matches_reference_spmd(tiny, spmd, name):
    c = SPMD[name]
    Xp = _X(tiny, rows=c["rows"], ell=not c["dense"])
    loss = td.make_loss(c["loss"])
    y = None if c["Y"] is None else labels_from_numpy(c["Y"], device="cpu")
    p = ts.sharded_passcode_solve(
        Xp, loss, mesh=_pod_mesh(c["pods"], c["p"], c["model"]), y=y,
        device="cpu", **c["kw"])
    r = types.SimpleNamespace(**spmd[name])
    if y is None:
        _assert_result(p, r, Xp, loss)
    else:
        _assert_tasks(p, r, Xp, c["Y"], loss)
    if c["kw"].get("adaptive"):
        # the pod latch: its flags follow the rule from its own gaps
        g, f = p.gaps.tolist(), p.delay.tolist()
        latch = [1.0]
        for k in range(1, len(g)):
            latch.append(min(latch[-1], float(
                k == 1 or g[k - 1] <= 0.5 * g[k - 2])))
        assert f == latch


# ---------------------------------------------------- staleness, warm


def test_staleness_sweep_eps_grows_with_pod_delay(tiny):
    """The port's twin of the reference's sweep, on the pod solve at
    (pod = 4, data = 1): mean ε is float noise at delay 0 and does not
    shrink as more merges stay in flight; the stalest gap stays within a
    bounded factor of the synchronous one."""
    Xp = _X(tiny)
    final, mean_eps = {}, {}
    for delay in (0, 1, 2, 4):
        r = ts.sharded_passcode_solve(
            Xp, td.SquaredHinge(), mesh=_pod_mesh(4), epochs=8,
            block_size=B, pod_delay_rounds=delay, seed=0, device="cpu")
        final[delay] = float(r.gaps[-1])
        mean_eps[delay] = float(r.eps.mean())
    assert mean_eps[0] < 1e-4, mean_eps
    for lo, hi in ((0, 1), (1, 2), (2, 4)):
        assert mean_eps[hi] >= mean_eps[lo] - 1e-4, mean_eps
    for delay in (1, 2, 4):
        assert np.isfinite(final[delay])
        assert final[delay] <= 20.0 * final[0], final


@pytest.mark.parametrize("to_pods", [1, 3])
def test_warm_start_onto_another_pod_count(tiny, to_pods):
    """(α, ŵ) carried from a 2-pod solve warm-start a solve on another
    pod count: held to the reference's oracle started from the same
    state, and its first gap below the carried state's last."""
    Xp = _X(tiny)
    first = ts.sharded_passcode_solve(Xp, td.SquaredHinge(),
                                      mesh=_pod_mesh(2), epochs=3,
                                      block_size=B, seed=7, device="cpu")
    r = ts.sharded_passcode_solve(
        Xp, td.SquaredHinge(), mesh=_pod_mesh(to_pods), epochs=3,
        block_size=B, seed=7, alpha0=first.alpha, w0=first.w_hat,
        device="cpu")
    o = rc.cocoa_pod_solve(_ref_X(tiny), rd.SquaredHinge(), n_pods=to_pods,
                           epochs=3, block_size=B, seed=7,
                           alpha0=first.alpha.numpy(),
                           w0=first.w_hat.numpy())
    _assert_oracle(r, _ns(o), Xp, td.SquaredHinge())
    assert float(r.gaps[-1]) < float(first.gaps[-1])


def test_reference_pod_solve_in_process_needs_the_host_finalize(tiny,
                                                                monkeypatch):
    """ROADMAP C.9: on the installed jax a pod solve of the reference
    raises in ``_finalize`` even on one device; with α, w and the rowmap
    fetched to the host it runs and matches the port's."""
    X = _ref_X(tiny)
    mesh = jax.make_mesh((1, 1), ("pod", "data"))
    kw = dict(epochs=3, block_size=B, seed=1, pod_delay_rounds=1)
    try:
        rs.sharded_passcode_solve(X, rd.Hinge(), mesh=mesh, **kw)
        raised = False
    except Exception as e:  # jax's ShardingTypeError
        raised = type(e).__name__ == "ShardingTypeError"
    monkeypatch.setattr(rs, "_finalize", finalize_on_host(rs._finalize))
    r = rs.sharded_passcode_solve(X, rd.Hinge(), mesh=mesh, **kw)
    p = ts.sharded_passcode_solve(_X(tiny), td.Hinge(), mesh=_pod_mesh(1),
                                  device="cpu", **kw)
    _assert_result(p, r, _X(tiny), td.Hinge())
    assert raised or jax.__version__ != "0.9.0"


# ------------------------------------------- the pod grid, plain versions


def _views(rng, P, width):
    return torch.from_numpy((rng.standard_normal((P, width)) * 0.1)
                            .astype(np.float32))


@pytest.mark.parametrize("P,p", [(2, 2), (3, 1), (2, 3)])
def test_pod_grid_plain_versions_read_their_pods_view(tiny, P, p):
    """On the CPU the pod grid runs the plain versions, which give each
    shard its pod's view: the same as handing every shard its pod's view
    as its own (B1, B2, B4 + B5), and the CPU wrappers launch nothing."""
    rng = np.random.default_rng(5)
    S, n_loc, b = P * p, 20, 8
    Xe, Xd = _X(tiny, rows=S * n_loc, ell=True), _X(tiny, rows=S * n_loc)
    ids = torch.from_numpy(rng.integers(0, n_loc, (S, b)).astype(np.int32))
    alpha = torch.from_numpy(rng.uniform(0, 0.5, S * n_loc)
                             .astype(np.float32))
    loss = td.Logistic(0.7)
    launches = dcd_ell_shards.pod_launches
    we = _views(rng, P, Xe.n_features + 1)
    we[:, -1] = 0.0
    qe = Xe.row_sq_norms()
    ka, kdw = dcd_ell_shards(Xe.indices, Xe.values, alpha, we, qe, loss=loss,
                             idx=ids, n_loc=n_loc)
    oa, odw = dcd_ell_shards_plain(Xe.indices, Xe.values, alpha,
                                   we.repeat_interleave(p, 0), qe, loss=loss,
                                   idx=ids, n_loc=n_loc)
    assert torch.equal(ka, oa) and torch.equal(kdw, odw)
    assert dcd_ell_shards.pod_launches == launches
    wd = _views(rng, P, Xd.shape[1])
    qd = (Xd * Xd).sum(1)
    ka, kdw = ops.dcd_block_update(Xd, qd, alpha, wd, ids, loss=loss,
                                   n_loc=n_loc)
    oa, odw = dcd_indexed_shards_plain(Xd, alpha, wd.repeat_interleave(p, 0),
                                       qd, loss=loss, idx=ids, n_loc=n_loc)
    assert torch.equal(ka, oa) and torch.equal(kdw, odw)
    fse = tsp.ell_column_split(Xe, 2)
    w2 = torch.from_numpy((rng.standard_normal((P, 2, fse.d_loc + 1)) * 0.1)
                          .astype(np.float32))
    w2[..., -1] = 0.0
    q2 = fse.row_sq_norms()
    ka, kdw = ops.dcd_feature_block_update(fse.indices, fse.values, q2,
                                           alpha, w2, ids, loss=loss,
                                           n_loc=n_loc)
    own = w2.repeat_interleave(p, 0)
    oa, odw = ops.dcd_feature_block_update(fse.indices, fse.values, q2,
                                           alpha, own, ids, loss=loss,
                                           n_loc=n_loc)
    assert torch.equal(ka, oa) and torch.equal(kdw, odw)
    assert feat.dcd_feature_gram.pod_launches == 0


@pytest.mark.parametrize("views,shards,want", [
    (None, 6, (1, 6, 1)),  # one w every shard reads
    (6, 6, (1, 6, 1)),  # a view a shard
    (2, 6, (2, 3, 3)),  # a view a pod: 2 pods of 3 shards
    (3, 6, (3, 2, 2)),
    (1, 6, (1, 6, 6)),  # one view serving all six shards
    (4, 6, None),  # 4 views do not split 6 shards
])
def test_pod_grid_reads_the_pods_from_w(views, shards, want):
    """The wrappers take the pod layout from w's shape: (K, d1) or
    (K, g, d1), g views of w each serving shards / g consecutive
    shards, a pod grid when 1 < g < shards."""
    from repro_torch.kernels.dcd_ell import pod_grid

    K = 3
    W = torch.zeros((K, 5) if views is None else (K, views, 5))
    if want is None:
        with pytest.raises(ValueError, match="views of w"):
            pod_grid(W, K, shards)
    else:
        assert pod_grid(W, K, shards) == want
    with pytest.raises(ValueError, match="a task each"):
        pod_grid(W, K + 1, shards)


@pytest.mark.parametrize("tasks", [False, True], ids=["binary", "k2"])
@pytest.mark.parametrize("views,ok", [(None, True), (6, True), (2, True),
                                      (3, True), (4, False)])
def test_feature_block_check_reads_the_views_from_w(tasks, views, ok):
    """B4's and B5's operand check takes w's views from its shape, as
    ``pod_grid`` does: one shared (m, d1) w, or g views for p data
    shards, g | p (a view a shard, or a view a pod)."""
    m, p, b, k, d1 = 4, 6, 8, 5, 11
    cols = torch.zeros((p * 4, m, k), dtype=torch.int32)
    vals = torch.zeros((p * 4, m, k))
    lead = (2,) if tasks else ()
    w = torch.zeros((*lead, m, d1) if views is None
                    else (*lead, views, m, d1))
    idx = torch.zeros((p, b), dtype=torch.int32)
    if ok:
        feat._check_block(cols, vals, w, idx, tasks)
        _, _, _, _, stride, _, serves, n_pods = feat._grid(idx, w, tasks)
        g = 1 if views is None else views
        assert serves == (p // g if views is not None else 1)
        assert n_pods == (g if 1 < g < p else 1)
        assert stride == (0 if views is None else m * d1)
    else:
        with pytest.raises(ValueError, match="for g | p"):
            feat._check_block(cols, vals, w, idx, tasks)


def test_pod_plans_keep_each_ctas_layout():
    """P pods multiply the grid and B4's workspace and change no CTA's
    layout: every plan at P pods is the P = 1 plan with its count."""
    assert tm.dcd_ell_plan(64, 73, 47_236, False, 4, 1, 2) == (
        tm.dcd_ell_plan(64, 73, 47_236)._replace(shards=4, pods=2))
    assert tm.dcd_dense_plan(64, 54, False, 4, 7, 2) == tm.dcd_dense_plan(
        64, 54)._replace(shards=4, tasks=7, pods=2)
    g = tm.gram_plan(4, 64, 40, 1000, 1, 1, 2)
    assert g == tm.gram_plan(4, 64, 40, 1000)._replace(pods=2)
    u = tm.feature_update_plan(4, 64, 40, 1000, 1, 1, 2)
    assert u == tm.feature_update_plan(4, 64, 40, 1000)._replace(pods=2)
    ws = feat.gram_workspace(4, 64, 40, 1000, torch.device("cpu"), 2, 3)
    assert tuple(ws.lc.shape) == (3 * 2 * 4, 64, 40)
    assert tuple(ws.part.shape) == (3 * 2 * 4, g.classes, 64, 64)
