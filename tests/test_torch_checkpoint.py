"""The solver's checkpoints (``repro_torch.train.checkpoint``,
``repro_torch.resilience.state``): the twins of the solver-state tests
of ``tests/test_checkpoint.py``, the on-disk format against the
reference's, checkpoints carried across in both directions, and the
SIGKILL resumes of ``tests/test_resilience_kill.py``.

* The format — the same flat dict saved by both packages' writers gives
  the same manifest (leaf order, names, shapes, dtypes, content hash)
  and the same arrays.
* Port → reference: the reference's ``load_solver_state`` reads a
  checkpoint of the port's ``solve_segmented`` with the names the
  reference's own checkpoint of the same solve has, every leaf of its
  shape, the integer and boolean leaves equal and the float leaves at
  atol 1e-5 (the gap-like ones at 1e-5 + 1e-6·M).
* Reference → port: a solve resumed by the port from the reference's
  checkpoint takes the bit path (``solver_state_from_numpy``: the leaves
  as they are, the in-flight Δw included) and lands on the reference's
  uninterrupted run at atol 1e-5.
* Process death, in child processes on the CPU with the port only: a
  solve on a (pod = 2, data = 2) mesh killed with SIGKILL after its
  second segment and before its save resumes from epoch 4 bit for bit on
  the same mesh, and elastically onto (4, 2) within twice the
  uninterrupted (4, 2) run's last gap + 1e-3 (the reference's bound).
  The reference's own twins fail on jax 0.9.0 (ROADMAP C.4).
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import resilience as rr
from repro.core import duals as rd
from repro.core import sharded as rs
from repro.train import checkpoint as rck
from repro_torch.core import duals as td
from repro_torch.core import sharded as ts
from repro_torch.dist.mesh import SolverMesh
from repro_torch.resilience import (
    load_newest_solver_state,
    load_solver_state,
    solve_segmented,
)
from repro_torch.resilience import segmented as tseg
from repro_torch.convert import solver_state_from_numpy
from repro_torch.train.checkpoint import (
    available_steps,
    gc_checkpoints,
    latest_step,
    save_checkpoint,
)

from test_torch_shards import finalize_on_host
from test_torch_solver import ATOL, _gap_atol

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")


def _state():
    """A solver state as the segmented solve carries it: tensors of the
    state's dtypes, a key, the host-side counters."""
    g = torch.Generator().manual_seed(0)
    return {"alpha": torch.rand((3, 40), generator=g),
            "w": torch.randn((3, 9), generator=g),
            "key": torch.tensor([[0, 7]] * 3, dtype=torch.int64),
            "act": torch.rand((3, 40), generator=g) > 0.5,
            "nrun": torch.full((3,), 5, dtype=torch.int32),
            "epoch": torch.tensor(4, dtype=torch.int32),
            "meta_seed": np.int64(3)}


def _eq_state(saved, loaded):
    assert set(loaded) == set(saved)
    for k, v in saved.items():
        want = v.numpy() if torch.is_tensor(v) else np.asarray(v)
        assert loaded[k].dtype == want.dtype, k
        np.testing.assert_array_equal(loaded[k], want)


# ------------------------------------------------ tests/test_checkpoint.py


def test_roundtrip_exact(tmp_path):
    state = _state()
    path = save_checkpoint(str(tmp_path), 7, state)
    assert os.path.isdir(path) and path.endswith("ckpt_7")
    _eq_state(state, load_solver_state(str(tmp_path), 7))


def test_integrity_check(tmp_path):
    path = save_checkpoint(str(tmp_path), 1, _state())
    mf = os.path.join(path, "manifest.json")
    m = json.load(open(mf))
    m["content_hash"] = "0" * 64
    json.dump(m, open(mf, "w"))
    with pytest.raises(ValueError, match="integrity"):
        load_solver_state(str(tmp_path), 1)
    load_solver_state(str(tmp_path), 1, validate=False)


def test_gc_keeps_last_k(tmp_path):
    for s in range(6):
        save_checkpoint(str(tmp_path), s, _state())
    gc_checkpoints(str(tmp_path), keep=2)
    left = sorted(d for d in os.listdir(tmp_path) if d.startswith("ckpt_"))
    assert left == ["ckpt_4", "ckpt_5"]
    assert latest_step(str(tmp_path)) == 5


def test_save_sweeps_orphaned_tmp_dirs(tmp_path):
    orphan = tmp_path / ".tmp_ckpt_dead"
    orphan.mkdir()
    (orphan / "arrays.npz").write_bytes(b"partial")
    save_checkpoint(str(tmp_path), 1, _state())
    assert not orphan.exists()
    assert latest_step(str(tmp_path)) == 1


def test_listers_skip_non_checkpoint_entries(tmp_path):
    save_checkpoint(str(tmp_path), 3, _state())
    save_checkpoint(str(tmp_path), 12, _state())
    (tmp_path / "ckpt_12_old").mkdir()
    (tmp_path / "ckpt_abc").mkdir()
    (tmp_path / "notes.txt").write_text("keep me")
    assert latest_step(str(tmp_path)) == 12
    gc_checkpoints(str(tmp_path), keep=1)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_12", "ckpt_12_old",
                                            "ckpt_abc", "notes.txt"]
    assert latest_step(str(tmp_path / "missing")) is None


def test_available_steps_lists_sorted(tmp_path):
    assert available_steps(str(tmp_path / "missing")) == []
    for s in (12, 3, 7):
        save_checkpoint(str(tmp_path), s, _state())
    os.makedirs(tmp_path / "ckpt_5_old")
    (tmp_path / "notes.txt").write_text("x")
    assert available_steps(str(tmp_path)) == [3, 7, 12]


def test_load_newest_falls_back_past_gc_race(tmp_path):
    state = {"w_canon": torch.arange(4.0), "meta_epoch": np.int32(2)}
    for s in (2, 4, 6):
        save_checkpoint(str(tmp_path), s, state)
    os.remove(tmp_path / "ckpt_6" / "manifest.json")
    shutil.rmtree(tmp_path / "ckpt_6")
    loaded, step = load_newest_solver_state(str(tmp_path))
    assert step == 4
    np.testing.assert_array_equal(loaded["w_canon"], np.arange(4.0,
                                                                dtype=np.float32))
    save_checkpoint(str(tmp_path), 8, state)
    os.remove(tmp_path / "ckpt_8" / "arrays.npz")
    loaded, step = load_newest_solver_state(str(tmp_path))
    assert step == 4
    for entry in os.listdir(tmp_path):
        shutil.rmtree(tmp_path / entry, ignore_errors=True)
    with pytest.raises(FileNotFoundError):
        load_newest_solver_state(str(tmp_path / "empty"))


def test_load_newest_does_not_mask_corruption(tmp_path):
    state = {"w_canon": torch.arange(4.0)}
    save_checkpoint(str(tmp_path), 1, state)
    save_checkpoint(str(tmp_path), 2, state)
    np.savez(str(tmp_path / "ckpt_2" / "arrays.npz"),
             leaf_0=np.full(4, 7.0, dtype=np.float32))
    with pytest.raises(ValueError, match="integrity"):
        load_newest_solver_state(str(tmp_path))


# ------------------------------------------------- against the reference


def test_format_matches_reference(tmp_path):
    """The same flat state through both writers: one manifest, one set
    of arrays; each package's loader reads the other's checkpoint."""
    state = _state()
    as_np = {k: (v.numpy() if torch.is_tensor(v) else v)
             for k, v in state.items()}
    ours = save_checkpoint(str(tmp_path / "port"), 5, state)
    theirs = rck.save_checkpoint(str(tmp_path / "ref"), 5, as_np)
    m_ours = json.load(open(os.path.join(ours, "manifest.json")))
    m_theirs = json.load(open(os.path.join(theirs, "manifest.json")))
    assert m_ours == m_theirs
    a, b = (np.load(os.path.join(p, "arrays.npz")) for p in (ours, theirs))
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        assert a[f].dtype == b[f].dtype
        np.testing.assert_array_equal(a[f], b[f])
    _eq_state(state, rr.load_solver_state(str(tmp_path / "port"), 5))
    _eq_state(state, load_solver_state(str(tmp_path / "ref"), 5))


def _data(n=96, d=12, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return X * y[:, None], y


# the cross-format solves: a delayed round in flight (dw), a K = 3
# multi-task solve with shrinking (act, nrun, rp, dwo) and a pod FIFO
CROSS = {
    "delayed": dict(delay_rounds=1),
    "K3_shrink": dict(tasks=3, shrink_every=1),
    "pod_fifo": dict(mesh=("pod", "data"), pod_delay_rounds=1),
}
SEG = dict(epochs=6, checkpoint_every=2, seed=3, keep=10)


def _cross_kw(c, port):
    c = dict(c)
    tasks, axes = c.pop("tasks", 0), c.pop("mesh", None)
    X, y = _data()
    kw = dict(SEG, **c)
    if tasks:
        X = X * y[:, None]  # unfolded
        kw["y"] = np.where(np.arange(96)[None] % tasks
                           == np.arange(tasks)[:, None], 1.0,
                           -1.0).astype(np.float32)
    if port:
        X = torch.from_numpy(X)
        if tasks:
            kw["y"] = torch.from_numpy(kw["y"])
        if axes:
            kw["mesh"] = SolverMesh(axes, (1, 1))
        kw.update(CPU)
    elif axes:
        kw["mesh"] = jax.make_mesh((1, 1), axes)
    return X, kw


@pytest.fixture(scope="module")
def ref_ckpts(tmp_path_factory):
    """Each cross-format solve by the reference, uninterrupted, with its
    checkpoints (its ``_finalize`` fetched to the host)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rs, "_finalize", finalize_on_host(rs._finalize))
        for name, c in CROSS.items():
            d = str(tmp_path_factory.mktemp(f"ref_{name}"))
            X, kw = _cross_kw(c, port=False)
            out[name] = (d, rr.solve_segmented(X, rd.Hinge(C=0.5),
                                               ckpt_dir=d, **kw))
    return out


def _gap_like(k):
    return k in ("gaps", "epsb", "gph", "eph", "gapprev")


@pytest.mark.parametrize("name", list(CROSS))
def test_reference_reads_port_checkpoint(ref_ckpts, name, tmp_path):
    ref_dir, _ = ref_ckpts[name]
    X, kw = _cross_kw(CROSS[name], port=True)
    solve_segmented(X, td.Hinge(0.5), ckpt_dir=str(tmp_path), **kw)
    assert available_steps(str(tmp_path)) == [2, 4, 6]
    Xg = X if not CROSS[name].get("tasks") else None
    for step in (2, 6):
        ours = rr.load_solver_state(str(tmp_path), step)
        theirs = rr.load_solver_state(ref_dir, step)
        assert set(ours) == set(theirs)
        tol = (_gap_atol(Xg, torch.from_numpy(theirs["alpha_canon"]),
                         td.Hinge(0.5)) if Xg is not None else 1e-4)
        for k, v in theirs.items():
            assert ours[k].shape == v.shape, k
            assert ours[k].dtype == v.dtype, k
            if v.dtype.kind in "biu":
                np.testing.assert_array_equal(ours[k], v, err_msg=k)
            else:
                np.testing.assert_allclose(
                    ours[k], v, rtol=0, atol=tol if _gap_like(k) else ATOL,
                    err_msg=k)


@pytest.mark.parametrize("name", list(CROSS))
def test_port_resumes_reference_checkpoint(ref_ckpts, name, tmp_path):
    """The reference's checkpoint of epoch 2 (the later ones wiped)
    resumes in the port through the bit path and lands on the
    reference's uninterrupted run."""
    ref_dir, full = ref_ckpts[name]
    d = str(tmp_path / "ckpt")
    shutil.copytree(os.path.join(ref_dir, "ckpt_2"),
                    os.path.join(d, "ckpt_2"))
    X, kw = _cross_kw(CROSS[name], port=True)
    setup = ts.solver_mouth(X, td.Hinge(0.5), **{
        k: v for k, v in kw.items()
        if k not in ("epochs", "checkpoint_every", "keep")})
    st, e, rung = tseg._restore(setup, d, 2, 6, watchdog=True)
    raw = rr.load_solver_state(d, 2)
    assert (e, rung) == (2, 0)
    want = solver_state_from_numpy(
        {k: v for k, v in raw.items()
         if not k.startswith("meta_") and not k.endswith("_canon")}, setup)
    assert set(st) == set(want)
    for k in st:  # the leaves as they are: the bit path
        assert torch.equal(st[k], want[k]), k
    res = solve_segmented(X, td.Hinge(0.5), ckpt_dir=d, resume=True, **kw)
    assert res.resumed_from == 2 and res.attempts == (1, 1)
    np.testing.assert_allclose(res.result.alpha.numpy(),
                               np.asarray(full.result.alpha), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(res.result.w_hat.numpy(),
                               np.asarray(full.result.w_hat), rtol=0,
                               atol=ATOL)


# --------------------------------------------------------- process death

_PRELUDE = textwrap.dedent("""
    import sys
    sys.path.insert(0, {src!r})
    import numpy as np, torch
    from repro_torch.core.duals import SquaredHinge
    from repro_torch.dist.mesh import SolverMesh
    from repro_torch.resilience import FaultPlan, solve_segmented

    rng = np.random.default_rng(0)
    X = torch.from_numpy(
        rng.normal(size=(102, 12)).astype(np.float32)
        * np.where(rng.random(102) < 0.5, -1.0, 1.0)
          .astype(np.float32)[:, None])
    loss = SquaredHinge(1.0)
    kw = dict(epochs=12, checkpoint_every=4, block_size=16, seed=0,
              device="cpu")
    mesh2 = SolverMesh(("pod", "data"), (2, 2))
    mesh4 = SolverMesh(("pod", "data"), (4, 2))
""")

_KILLED = _PRELUDE + textwrap.dedent("""
    solve_segmented(X, loss, mesh=mesh2, ckpt_dir={ckpt!r},
                    fault_plan=FaultPlan(sigkill_segment=1), **kw)
    print("UNREACHABLE")
""")

_RESUMED = _PRELUDE + textwrap.dedent("""
    full = solve_segmented(X, loss, mesh=mesh2, **kw)
    res = solve_segmented(X, loss, mesh=mesh2, ckpt_dir={ckpt!r},
                          resume=True, **kw)
    assert res.resumed_from == 4, res.resumed_from
    assert res.attempts == (1, 1), res.attempts
    for k in ("alpha", "w_hat", "gaps", "eps"):
        assert torch.equal(getattr(full.result, k),
                           getattr(res.result, k)), k
    print("KILL_RESUME_OK")
""")

_ELASTIC = _PRELUDE + textwrap.dedent("""
    ref = solve_segmented(X, loss, mesh=mesh4, **kw)
    res = solve_segmented(X, loss, mesh=mesh4, ckpt_dir={ckpt!r},
                          resume=True, **kw)
    assert res.resumed_from == 4, res.resumed_from
    g_ref = float(ref.result.gaps[-1])
    g_el = float(res.result.gaps[-1])
    assert np.isfinite(g_el) and g_el <= 2.0 * g_ref + 1e-3, (g_el, g_ref)
    print("ELASTIC_RESUME_OK", g_el, g_ref)
""")


def _run(code):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)


def _kill(ckpt):
    out = _run(_KILLED.format(src=str(ROOT / "src"), ckpt=ckpt))
    assert out.returncode == -signal.SIGKILL, (out.returncode,
                                               out.stderr[-3000:])
    assert "UNREACHABLE" not in out.stdout
    assert os.path.isdir(os.path.join(ckpt, "ckpt_4"))
    assert not os.path.isdir(os.path.join(ckpt, "ckpt_8"))


def test_sigkill_resume_bit_identical(tmp_path):
    ckpt = str(tmp_path)
    _kill(ckpt)
    out = _run(_RESUMED.format(src=str(ROOT / "src"), ckpt=ckpt))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "KILL_RESUME_OK" in out.stdout


def test_sigkill_resume_elastic_pod_change(tmp_path):
    ckpt = str(tmp_path)
    _kill(ckpt)
    out = _run(_ELASTIC.format(src=str(ROOT / "src"), ckpt=ckpt))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ELASTIC_RESUME_OK" in out.stdout
