"""The segmented, fault-tolerant solve (``repro_torch.resilience``)
against the reference's ``repro.resilience`` and against itself.

Spine, at the reference's own test sizes (n = 96, d = 12 folded rows;
K = 16 classes of 64 rows for the multi-task resume):

* the policies — ``watchdog_trip`` and ``degrade_ladder`` equal the
  reference's on a grid with +inf baselines, NaN and the floor, and
  ``pipeline_state_keys`` is the reference's for every knob combination;
* the port against itself, bit for bit (α, ŵ, gaps, ε): segmented at
  ``checkpoint_every`` 1 and 2 against the whole solve, a resume against
  the uninterrupted run and a fault replayed against the clean run, on
  the 1-D dense and ELL meshes, the 2-D mesh (the overlapped round, which
  the fused engine's plain versions run on the CPU) and a pod mesh, each
  binary and with K = 3;
* the port against the reference's ``solve_segmented`` on the same
  inputs — the twins of ``tests/test_resilience.py`` (sync, delayed,
  shrink + adaptive, 2-D delayed, pod delay 1, resume, nan, payload,
  persistent, async-only, drop and dup on a pod mesh) and of
  ``test_multitask.py::test_segmented_multitask_resume_bit_identical``:
  the state at atol 1e-5, the gaps at 1e-5 + 1e-6·M
  (``test_torch_solver._gap_atol``), and the recovery record (health,
  attempts, rollbacks, rung, epochs lost, resumed-from; and for
  ``SolverDiverged`` its epoch, history and result's rounds) exactly.
  The reference's ``_finalize`` raises on a pod mesh on jax 0.9.0
  (ROADMAP C.9), so its solves run with it fetched to the host
  (``test_torch_shards.finalize_on_host``); nothing of ``repro``
  changes.  The reference runs once per module.

The checkpoint format, the cross-format resumes and the SIGKILL resumes
are in ``test_torch_checkpoint.py``.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import resilience as rr
from repro.core import duals as rd
from repro.core import sharded as rs
from repro.data import ovr_labels as r_ovr_labels
from repro.dist import mesh as rm
from repro_torch.core import duals as td
from repro_torch.core import sharded as ts
from repro_torch.data.sparse import dense_to_ell
from repro_torch.dist import mesh as tm
from repro_torch.dist.mesh import SolverMesh, solver_mesh, solver_mesh_2d
from repro_torch.resilience import (
    FaultPlan,
    SolverDiverged,
    corrupt_payload,
    drain_state,
    solve_segmented,
)

from test_torch_shards import finalize_on_host
from test_torch_solver import ATOL, _gap_atol

CPU = dict(device="cpu")


def _data(n=96, d=12, seed=0):
    """The reference test's rows: normal, folded by ±1 labels."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return X * y[:, None], y


def _mt_data(n=64, d=16, n_classes=16, seed=3):
    """``test_multitask._data``: unfolded rows, class ids with a planted
    signal."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    X[np.arange(n), y % d] += 2.0
    return X, y


def _bits(a, b):
    for k in ("alpha", "w_hat", "gaps", "eps"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def _record(r):
    return (r.health, r.attempts, r.rollbacks, r.rung, r.epochs_lost,
            r.resumed_from)


# ------------------------------------------------------------- policies


def test_watchdog_trip_matches_reference():
    vals = np.array([np.inf, np.nan, 0.0, 1e-4, 0.5, 1.0, 4.0, 5.0],
                    np.float32)
    g = np.stack(np.meshgrid(vals, vals, vals, vals, [0, 3],
                             indexing="ij")).reshape(5, -1)
    gp, gn, ep, en = (g[i].astype(np.float32) for i in range(4))
    nb = g[4].astype(np.int32)
    for blowup, floor in ((4.0, 1e-3), (2.0, 0.0), (1.0, 0.5)):
        ref = rm.watchdog_trip(gp, gn, ep, en, nb, blowup=blowup,
                               floor=floor)
        got = tm.watchdog_trip(*(torch.from_numpy(a) for a in
                                 (gp, gn, ep, en, nb)),
                               blowup=blowup, floor=floor)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert set(np.asarray(ref).tolist()) == {0, 1, 2}


@pytest.mark.parametrize("rung", [-1, 0, 1, 2])
def test_degrade_ladder_matches_reference(rung):
    for dr in (0, 2):
        for pdr in (0, 1):
            for ov in (True, False, "auto"):
                kw = dict(delay_rounds=dr, pod_delay_rounds=pdr, overlap=ov)
                assert (tm.degrade_ladder(rung, **kw)
                        == rm.degrade_ladder(rung, **kw))


def test_pipeline_state_keys_match_reference():
    for dyn in (False, True):
        for shrink in (False, True):
            for adaptive in (False, True):
                for fifo in (0, 1, 3):
                    for wd in (False, True):
                        kw = dict(dyn=dyn, shrink_on=shrink,
                                  adaptive=adaptive, pod_fifo=fifo,
                                  watchdog=wd)
                        assert (ts.pipeline_state_keys(**kw)
                                == rs.pipeline_state_keys(**kw))


def test_init_state_has_the_schema():
    X, _ = _data()
    for kw, want in [
            (dict(), dict(dyn=False, pod_fifo=0)),
            (dict(shrink_every=1, adaptive=True, delay_rounds=1),
             dict(dyn=True, pod_fifo=0)),
            (dict(mesh=SolverMesh(("pod", "data"), (2, 2)),
                  pod_delay_rounds=2), dict(dyn=False, pod_fifo=2))]:
        setup = ts.prepare_solver(torch.from_numpy(X), td.Hinge(0.5), **kw,
                                  **CPU)
        st = ts.init_pipeline_state(setup, total_epochs=4, watchdog=True)
        tn = setup.tuning
        assert set(st) == set(ts.pipeline_state_keys(
            shrink_on=tn.shrink_every > 0, adaptive=tn.adaptive,
            watchdog=True, **want))
        assert st["epoch"].shape == () and st["alpha"].shape == (
            1, setup.n_pad)
        if want["pod_fifo"]:
            assert st["pbuf"].shape == (1, 2, *setup.w_shape)
        if want["dyn"]:
            assert st["dwo"].shape == (1, setup.p, *setup.w_shape)


# ------------------------------------------------- the port against itself

MESHES = {
    "dense": dict(mesh=solver_mesh(n_devices=2), delay_rounds=1),
    "ell": dict(mesh=solver_mesh(n_devices=2), shrink_every=1, repack=True,
                repack_threshold=0.9),
    "2d": dict(mesh=solver_mesh_2d(data=2, model=2), use_kernel=True,
               delay_rounds=1),
    "pod": dict(mesh=SolverMesh(("pod", "data"), (2, 2)),
                pod_delay_rounds=1),
}


def _port_X(kind):
    X, y = _data()
    Xt = torch.from_numpy(X * y[:, None])  # unfolded, for the K = 3 labels
    if kind != "dense":
        Xt = dense_to_ell(Xt, device="cpu")
    return Xt, torch.from_numpy(y)


@pytest.mark.parametrize("scenario", ["every1", "every2", "resume", "fault"])
@pytest.mark.parametrize("tasks", [0, 3], ids=["binary", "K3"])
@pytest.mark.parametrize("kind", sorted(MESHES))
def test_segmented_bit_identical(kind, tasks, scenario, tmp_path):
    """Segmented against whole, resume against uninterrupted, a NaN
    fault replayed against the clean run: α, ŵ, gaps and ε bit for
    bit."""
    Xt, y = _port_X(kind)
    lab = (y if not tasks else
           torch.where(torch.arange(96)[None] % tasks
                       == torch.arange(tasks)[:, None], 1.0, -1.0))
    kw = dict(epochs=6, block_size=16, seed=5, y=lab, **MESHES[kind], **CPU)
    loss = td.Hinge(0.5)
    if scenario.startswith("every"):
        ce = int(scenario[-1])
        base = ts.sharded_passcode_solve(Xt, loss, **kw)
        r = solve_segmented(Xt, loss, checkpoint_every=ce, **kw)
        assert r.health == 0 and r.attempts == (1,) * (6 // ce)
        _bits(base, r.result)
    elif scenario == "resume":
        d = str(tmp_path)
        full = solve_segmented(Xt, loss, checkpoint_every=2, ckpt_dir=d,
                               keep=10, **kw)
        for s in (4, 6):
            shutil.rmtree(os.path.join(d, f"ckpt_{s}"))
        res = solve_segmented(Xt, loss, checkpoint_every=2, ckpt_dir=d,
                              keep=10, resume=True, **kw)
        assert res.resumed_from == 2 and res.attempts == (1, 1)
        _bits(full.result, res.result)
    else:
        # on the pod mesh the poisoned merge of epoch 2 lands through the
        # FIFO at epoch 3, inside the segment (the census reads α and ŵ,
        # not the FIFO, as the reference's does: ROADMAP C.11)
        nan_e = 2 if kind == "pod" else 3
        clean = solve_segmented(Xt, loss, checkpoint_every=2, **kw)
        r = solve_segmented(Xt, loss, checkpoint_every=2,
                            fault_plan=FaultPlan(nan_psum_epoch=nan_e), **kw)
        assert r.attempts == (1, 2, 1) and r.rollbacks == 1
        assert r.epochs_lost == 2 and r.rung == 0 and r.health == 0
        _bits(clean.result, r.result)


def test_solve_counters_accumulate_over_segments():
    Xt, _ = _port_X("ell")
    kw = dict(epochs=4, block_size=16, seed=5, **MESHES["ell"], **CPU)
    ts.sharded_passcode_solve(Xt, td.Hinge(0.5), **kw)
    whole = (list(ts.sharded_passcode_solve.epoch_rounds),
             list(ts.sharded_passcode_solve.task_rounds))
    reads = ts.sharded_passcode_solve.host_reads
    solve_segmented(Xt, td.Hinge(0.5), checkpoint_every=1, **kw)
    assert (ts.sharded_passcode_solve.epoch_rounds,
            ts.sharded_passcode_solve.task_rounds) == whole
    # each epoch's round counts, and the watchdog once a segment and at
    # the end
    assert ts.sharded_passcode_solve.host_reads - reads == 4 + 4 + 1


# ------------------------------------------------ against the reference

REF_CASES = {
    "sync": dict(),
    "delayed": dict(delay_rounds=1),
    "shrink+adaptive": dict(delay_rounds=1, shrink_every=2, adaptive=True),
    "2d": dict(mesh=("data", "model"), delay_rounds=1, loss="sq", seed=4),
    "pod": dict(mesh=("pod", "data"), pod_delay_rounds=1, loss="sq",
                seed=4),
    "nan": dict(delay_rounds=1, plan=dict(nan_psum_epoch=3)),
    "payload": dict(plan=dict(corrupt_payload_segment=1, corrupt_frac=0.2)),
    "async_only": dict(delay_rounds=1, plan=dict(
        nan_psum_epoch=3, persistent=True, async_only=True)),
    "drop": dict(mesh=("pod", "data"), seed=2,
                 plan=dict(drop_merge_epoch=2)),
    "dup": dict(mesh=("pod", "data"), seed=2, plan=dict(dup_merge_epoch=2)),
}


def _case_kw(c, port):
    c = dict(c)
    plan = c.pop("plan", None)
    loss = c.pop("loss", "hinge")
    axes = c.pop("mesh", None)
    kw = dict(epochs=6, checkpoint_every=2, seed=c.pop("seed", 3), **c)
    if port:
        kw["loss"] = td.SquaredHinge(1.0) if loss == "sq" else td.Hinge(0.5)
        if plan:
            kw["fault_plan"] = FaultPlan(**plan)
        if axes:
            kw["mesh"] = SolverMesh(axes, (1, 1))
            if "model" in axes:
                kw["use_kernel"] = True  # the overlapped round
        kw.update(CPU)
    else:
        kw["loss"] = rd.SquaredHinge(C=1.0) if loss == "sq" else rd.Hinge(
            C=0.5)
        if plan:
            kw["fault_plan"] = rr.FaultPlan(**plan)
        if axes:
            kw["mesh"] = jax.make_mesh((1, 1), axes)
    return kw


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results, once per module (its ``_finalize``
    fetched to the host)."""
    X, _ = _data()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rs, "_finalize", finalize_on_host(rs._finalize))
        for name, c in REF_CASES.items():
            kw = _case_kw(c, port=False)
            out[name] = rr.solve_segmented(X, kw.pop("loss"), **kw)
        with pytest.raises(rr.SolverDiverged) as ei:
            rr.solve_segmented(X, rd.Hinge(C=0.5), epochs=6,
                               checkpoint_every=2, seed=3, max_retries=2,
                               fault_plan=rr.FaultPlan(nan_psum_epoch=3,
                                                       persistent=True))
        out["persistent"] = ei.value
        d = str(tmp_path_factory.mktemp("ref_resume"))
        kw = dict(epochs=6, checkpoint_every=2, seed=3, ckpt_dir=d, keep=10)
        out["full"] = rr.solve_segmented(X, rd.Hinge(C=0.5), **kw)
        for s in (4, 6):
            shutil.rmtree(os.path.join(d, f"ckpt_{s}"))
        out["resume"] = rr.solve_segmented(X, rd.Hinge(C=0.5), resume=True,
                                           **kw)
        Xm, ym = _mt_data()
        Y = np.asarray(r_ovr_labels(ym, 16))
        d = str(tmp_path_factory.mktemp("ref_mt"))
        kw = dict(epochs=6, checkpoint_every=2, seed=3, ckpt_dir=d, keep=10,
                  y=Y)
        out["mt_full"] = rr.solve_segmented(Xm, rd.Hinge(C=0.5), **kw)
        for s in (4, 6):
            shutil.rmtree(os.path.join(d, f"ckpt_{s}"))
        out["mt_resume"] = rr.solve_segmented(Xm, rd.Hinge(C=0.5),
                                              resume=True, **kw)
    return out


def _assert_close(port, ref, Xp, loss):
    """The state at atol 1e-5, each task's gaps and ε at 1e-5 + 1e-6·M."""
    a, w = port.alpha, port.w_hat
    np.testing.assert_allclose(a.numpy(), np.asarray(ref.alpha), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref.w_hat), rtol=0,
                               atol=ATOL)
    rows = a if a.dim() == 2 else a[None]
    for k, ak in enumerate(rows):
        tol = _gap_atol(Xp, ak, loss)
        g = port.gaps if a.dim() == 1 else port.gaps[k]
        e = port.eps if a.dim() == 1 else port.eps[k]
        rg = np.asarray(ref.gaps) if a.dim() == 1 else np.asarray(
            ref.gaps)[k]
        re_ = np.asarray(ref.eps) if a.dim() == 1 else np.asarray(ref.eps)[k]
        np.testing.assert_allclose(g.numpy(), rg, rtol=0, atol=tol)
        np.testing.assert_allclose(e.numpy(), re_, rtol=0, atol=tol)


@pytest.mark.parametrize("name", list(REF_CASES))
def test_segmented_matches_reference(ref, name):
    X, _ = _data()
    Xp = torch.from_numpy(X)
    kw = _case_kw(REF_CASES[name], port=True)
    loss = kw.pop("loss")
    r = solve_segmented(Xp, loss, **kw)
    assert _record(r) == _record(ref[name])
    _assert_close(r.result, ref[name].result, Xp, loss)
    assert np.isfinite(r.result.w_hat.numpy()).all()


def test_persistent_fault_raises_like_reference(ref):
    X, _ = _data()
    with pytest.raises(SolverDiverged) as ei:
        solve_segmented(torch.from_numpy(X), td.Hinge(0.5), epochs=6,
                        checkpoint_every=2, seed=3, max_retries=2,
                        fault_plan=FaultPlan(nan_psum_epoch=3,
                                             persistent=True), **CPU)
    ex, rx = ei.value, ref["persistent"]
    assert (ex.epoch, ex.history, ex.result.rounds) == (
        rx.epoch, rx.history, rx.result.rounds) == (2, (1, 3), 2)
    assert np.isfinite(ex.result.w_hat.numpy()).all()
    assert np.isfinite(ex.result.alpha.numpy()).all()
    _assert_close(ex.result, rx.result, torch.from_numpy(X), td.Hinge(0.5))


def test_resume_matches_reference(ref, tmp_path):
    X, _ = _data()
    Xp, loss, d = torch.from_numpy(X), td.Hinge(0.5), str(tmp_path)
    kw = dict(epochs=6, checkpoint_every=2, seed=3, ckpt_dir=d, keep=10,
              **CPU)
    full = solve_segmented(Xp, loss, **kw)
    for s in (4, 6):
        shutil.rmtree(os.path.join(d, f"ckpt_{s}"))
    res = solve_segmented(Xp, loss, resume=True, **kw)
    assert _record(res) == _record(ref["resume"])
    assert res.resumed_from == 2 and res.attempts == (1, 1)
    _bits(full.result, res.result)
    _assert_close(res.result, ref["full"].result, Xp, loss)


def test_multitask_resume_matches_reference(ref, tmp_path):
    """``test_segmented_multitask_resume_bit_identical``'s twin: the task
    axis survives the checkpoint, and the resumed K = 16 solve lands on
    the uninterrupted run bit for bit and on the reference's."""
    Xm, ym = _mt_data()
    Xp, loss = torch.from_numpy(Xm), td.Hinge(0.5)
    Y = torch.from_numpy(np.array(r_ovr_labels(ym, 16)))
    d = str(tmp_path)
    kw = dict(epochs=6, checkpoint_every=2, seed=3, ckpt_dir=d, keep=10,
              y=Y, **CPU)
    full = solve_segmented(Xp, loss, **kw)
    assert full.result.alpha.shape == (16, 64)
    for s in (4, 6):
        shutil.rmtree(os.path.join(d, f"ckpt_{s}"))
    res = solve_segmented(Xp, loss, resume=True, **kw)
    assert _record(res) == _record(ref["mt_resume"])
    assert res.resumed_from == 2
    _bits(full.result, res.result)
    # the gaps of each task read its labels: fold them for the tolerance
    np.testing.assert_allclose(res.result.alpha.numpy(),
                               np.asarray(ref["mt_full"].result.alpha),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(res.result.w_hat.numpy(),
                               np.asarray(ref["mt_full"].result.w_hat),
                               rtol=0, atol=ATOL)
    for k in range(16):
        Xk = Xp * Y[k][:, None]
        tol = _gap_atol(Xk, res.result.alpha[k], loss)
        np.testing.assert_allclose(
            res.result.gaps[k].numpy(),
            np.asarray(ref["mt_full"].result.gaps)[k], rtol=0, atol=tol)


# --------------------------------------------------------- the mouth


def test_resume_without_checkpoints_runs_fresh(tmp_path):
    X, _ = _data()
    r = solve_segmented(torch.from_numpy(X), td.Hinge(0.5), epochs=4,
                        checkpoint_every=2, seed=3, ckpt_dir=str(tmp_path),
                        resume=True, **CPU)
    assert r.resumed_from is None and r.attempts == (1, 1)


def test_merge_faults_need_pod_mesh():
    X, _ = _data()
    for plan in (FaultPlan(drop_merge_epoch=1), FaultPlan(dup_merge_epoch=1)):
        with pytest.raises(ValueError, match="pod"):
            solve_segmented(torch.from_numpy(X), td.Hinge(0.5), epochs=4,
                            checkpoint_every=2, fault_plan=plan, **CPU)


def test_input_validation_rejects_garbage():
    X, _ = _data(n=32, d=4)
    Xn = X.copy()
    Xn[3, 1] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        solve_segmented(torch.from_numpy(Xn), td.Hinge(1.0), epochs=1, **CPU)
    with pytest.raises(ValueError, match="checkpoint_every"):
        solve_segmented(torch.from_numpy(X), td.Hinge(1.0), epochs=2,
                        checkpoint_every=-1, **CPU)
    with pytest.raises(ValueError, match="ckpt_dir"):
        solve_segmented(torch.from_numpy(X), td.Hinge(1.0), epochs=2,
                        resume=True, **CPU)


# ------------------------------------------------ the state and faults


def test_drain_state_matches_reference():
    """Rung 1's drain on a pod solve's state (a FIFO of 2, a Δw and the
    adaptive latch in flight) against the reference's on the same values
    in its layout."""
    X, _ = _data()
    setup = ts.prepare_solver(
        torch.from_numpy(X), td.Hinge(0.5),
        mesh=SolverMesh(("pod", "data"), (2, 2)), pod_delay_rounds=2,
        adaptive=True, delay_rounds=1, **CPU)
    st = ts.init_pipeline_state(setup, total_epochs=4, watchdog=True)
    g = torch.Generator().manual_seed(0)
    for k in ("w", "dw", "pbuf"):
        st[k] = torch.randn(st[k].shape, generator=g)
    st["delay"] = torch.ones_like(st["delay"])
    target = ts.pipeline_state_keys(dyn=False, shrink_on=False,
                                    adaptive=True, pod_fifo=0, watchdog=True)
    ours = drain_state(st, target, p=setup.p)
    ref_st = {k: jax.numpy.asarray(v[0].numpy()) for k, v in st.items()
              if k not in ("epoch", "key")}
    theirs = rr.drain_state(ref_st, [k for k in target if k not in (
        "epoch", "key")])
    assert set(ours) == set(target) and "pbuf" not in ours
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k][0].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-6)
    assert int(ours["delay"].max()) == 0
    # the 2-D path losing its overlap gains the self-tuning scan's dwo
    assert drain_state(st, list(target) + ["dwo"], p=4)["dwo"].shape == (
        1, 4, *setup.w_shape)
    with pytest.raises(KeyError, match="synthesize"):
        drain_state(st, list(target) + ["act"])


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_corrupt_payload_poisons_values_only(kind):
    Xt, _ = _port_X(kind)
    setup = ts.prepare_solver(Xt, td.Hinge(0.5), **MESHES[kind], **CPU)
    bad = corrupt_payload(setup, frac=0.2, seed=7)
    again = corrupt_payload(setup, frac=0.2, seed=7)
    vals, bvals = ((setup.X[1], bad[1]) if isinstance(setup.X, tuple)
                   else (setup.X, bad))
    if isinstance(setup.X, tuple):
        assert torch.equal(bad[0], setup.X[0])
    nan = torch.isnan(bvals)
    assert torch.equal(nan, torch.isnan(
        again[1] if isinstance(again, tuple) else again))
    assert 0.1 < float(nan.float().mean()) < 0.3
    assert torch.equal(bvals[~nan], vals[~nan])
    assert not torch.isnan(vals).any()  # setup.X stays pristine


def test_pod_join_leave_resumes_solve():
    """``test_elastic::test_pod_join_leave_resumes_solve``'s twin (the
    reference's fails on jax 0.9.0, ROADMAP C.4): 4 epochs on (pod = 2,
    data = 2), pods join (4, 2), then leave (1, 2), (α, ŵ) carried by
    the warm start; the last gap within twice the uninterrupted 12-epoch
    (2, 2) run's + 1e-3."""
    from repro_torch.data import make_dataset
    X = make_dataset("tiny", device="cpu").dense_train()[:102]
    loss = td.SquaredHinge(1.0)
    kw = dict(block_size=16, seed=0, **CPU)
    mesh = {P: SolverMesh(("pod", "data"), (P, 2)) for P in (1, 2, 4)}
    ref = ts.sharded_passcode_solve(X, loss, mesh=mesh[2], epochs=12, **kw)
    r = ts.sharded_passcode_solve(X, loss, mesh=mesh[2], epochs=4, **kw)
    for P in (4, 1):
        r = ts.sharded_passcode_solve(X, loss, mesh=mesh[P], epochs=4,
                                      alpha0=r.alpha, w0=r.w_hat, **kw)
    g_ref, g_el = float(ref.gaps[-1]), float(r.gaps[-1])
    assert np.isfinite(g_el) and g_el <= 2.0 * g_ref + 1e-3, (g_el, g_ref)


def test_fixed_point_sum_is_order_free():
    """The card's gap sums w(α) in int64 fixed point
    (``core.sharded._scatter_fixed``): the same bits in any order of the
    terms, within 1e-12 of the float64 sum relative to its bound, and
    NaN when the bound is not finite."""
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 50, (20_000,), generator=g)
    terms = torch.randn(20_000, generator=g) * 3.0
    bound = terms.abs().sum()
    scale = ts._fixed_point_scale(bound)
    outs = []
    for perm in (torch.arange(20_000), torch.randperm(20_000, generator=g)):
        acc = torch.zeros(50, dtype=torch.int64)
        ts._scatter_fixed(acc, idx[perm], terms[perm], scale)
        outs.append(ts._from_fixed(acc, scale, bound))
    assert torch.equal(outs[0], outs[1])
    exact = torch.zeros(50, dtype=torch.float64).index_add_(
        0, idx, terms.double())
    err = float((outs[0].double() - exact).abs().max())
    assert err <= 1e-12 * float(bound) + 1e-6 * float(exact.abs().max())
    bad = ts._from_fixed(torch.zeros(3, dtype=torch.int64), scale,
                         torch.tensor(float("nan")))
    assert torch.isnan(bad).all()
