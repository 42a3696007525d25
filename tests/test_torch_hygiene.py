"""The port stands alone: no ``repro_torch`` module imports jax or the
JAX package ``repro``, and its entry points run on the card unless the
caller asks for the CPU — without a card they raise, never carry on."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.convert import (
    dense_from_numpy,
    ell_from_numpy,
    feature_sharded_from_numpy,
    labels_from_numpy,
    w2d_from_numpy,
)
from repro_torch.core import duals as td
from repro_torch.core.dcd import dcd_solve
from repro_torch.core.passcode import passcode_solve
from repro_torch.configs import get_smoke_config
from repro_torch.core.sharded import (
    make_sharded_epoch,
    sharded_passcode_feature,
    sharded_passcode_solve,
)
from repro_torch.models import init_cache, init_params, lm_features
from repro_torch.data.labels import ovr_labels
from repro_torch.data.sparse import dense_to_ell
from repro_torch.data.synthetic import make_dataset, make_paper_split
from repro_torch.dist.mesh import SolverMesh, solver_mesh_2d
from repro_torch.data.lm_data import MarkovCorpus
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.optim import make_schedule
from repro_torch.resilience import solve_segmented
from repro_torch.train import (
    LoopConfig,
    init_train_state,
    make_train_step,
    run_training,
)
from repro_torch.serve import (
    IncrementalTrainer,
    ScoreOutcome,
    ServeEngine,
    SnapshotStore,
    load_snapshot,
    make_snapshot,
)

from _dist_cases import run_world

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def test_no_module_imports_jax_or_repro():
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    assert "repro_torch.core.sharded" in mods and len(mods) >= 15
    assert {"repro_torch.serve", "repro_torch.serve.engine",
            "repro_torch.serve.trainer", "repro_torch.serve.snapshot",
            "repro_torch.serve.queue", "repro_torch.serve.metrics"} <= set(
        mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


ENTRY_POINTS = {
    "sharded_passcode_solve": lambda: sharded_passcode_solve(
        torch.ones((4, 2)), td.Hinge(), epochs=1),
    "dcd_solve": lambda: dcd_solve(torch.ones((4, 2)), td.Hinge(), epochs=1),
    "passcode_solve": lambda: passcode_solve(torch.ones((4, 2)), td.Hinge(),
                                             epochs=1),
    "make_dataset": lambda: make_dataset("tiny"),
    "make_paper_split": lambda: make_paper_split("covtype"),
    "dense_to_ell": lambda: dense_to_ell(np.eye(3)),
    "ell_from_numpy": lambda: ell_from_numpy(np.zeros((1, 1)),
                                             np.zeros((1, 1)), 1),
    "dense_from_numpy": lambda: dense_from_numpy(np.zeros((1, 1))),
    "feature_sharded_from_numpy": lambda: feature_sharded_from_numpy(
        np.zeros((1, 1, 1)), np.zeros((1, 1, 1)), 1, 1),
    "w2d_from_numpy": lambda: w2d_from_numpy(np.zeros(4), 2, 1),
    "sharded_passcode_solve_2d": lambda: sharded_passcode_solve(
        torch.ones((4, 2)), td.Hinge(), epochs=1,
        mesh=solver_mesh_2d(model=2)),
    "sharded_passcode_solve_multitask": lambda: sharded_passcode_solve(
        torch.ones((4, 2)), td.Hinge(), epochs=1, y=np.ones((3, 4))),
    "solve_segmented": lambda: solve_segmented(
        torch.ones((4, 2)), td.Hinge(), epochs=2, checkpoint_every=1),
    "solve_segmented_pods": lambda: solve_segmented(
        torch.ones((4, 2)), td.Hinge(), epochs=2, checkpoint_every=1,
        mesh=SolverMesh(("pod", "data"), (2, 1))),
    "ovr_labels": lambda: ovr_labels([0, 1, 2]),
    "labels_from_numpy": lambda: labels_from_numpy(np.ones((2, 3))),
    "ServeEngine": lambda: ServeEngine(SnapshotStore(make_snapshot(
        np.ones(3), 1, device="cpu")), k_max=2),
    "IncrementalTrainer": lambda: IncrementalTrainer(
        dense_to_ell(np.eye(3), device="cpu"), td.Hinge()),
    "make_snapshot": lambda: make_snapshot(np.ones(3), 1),
    "load_snapshot": lambda: load_snapshot("no_such_checkpoint_dir"),
    "sharded_passcode_feature": lambda: sharded_passcode_feature(
        torch.ones((4, 2)), td.Hinge(), epochs=1),
    "make_sharded_epoch": lambda: make_sharded_epoch(SolverMesh(
        ("data",), (1,)), td.Hinge()),
    "init_params": lambda: init_params(get_smoke_config("mamba2-780m"), 0),
    "init_cache": lambda: init_cache(get_smoke_config("mamba2-780m"), 1, 8),
    # lm_features runs where its parameters are: the default path's
    "lm_features": lambda: lm_features(
        get_smoke_config("mamba2-780m"),
        init_params(get_smoke_config("mamba2-780m"), 0),
        torch.zeros((1, 4), dtype=torch.int64)),
    "init_train_state": lambda: init_train_state(
        get_smoke_config("minicpm-2b"), 0),
    "MarkovCorpus": lambda: MarkovCorpus(97),
    # the loop through a step of the default path's state
    "run_training": lambda: run_training(
        init_train_state(get_smoke_config("minicpm-2b"), 0),
        make_train_step(get_smoke_config("minicpm-2b"),
                        schedule=make_schedule("cosine", peak_lr=1e-3,
                                               total_steps=2)),
        lambda t: None, LoopConfig(total_steps=1,
                                   ckpt_dir="no_such_checkpoint_dir")),
    "launch_train_main": lambda: train_main(["--arch", "minicpm-2b",
                                             "--steps", "1"]),
    "launch_serve_main": lambda: serve_main(["--arch", "minicpm-2b",
                                             "--gen", "2"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_raise_without_it(name,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_solve_segmented_runs_on_cpu_when_asked(tmp_path, monkeypatch):
    """Without a card, ``device="cpu"`` runs the segmented solve, its
    checkpoints and a resume, and nothing reaches for CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(epochs=2, checkpoint_every=1, ckpt_dir=str(tmp_path),
              block_size=2, device="cpu")
    r = solve_segmented(torch.ones((4, 2)), td.Hinge(), **kw)
    again = solve_segmented(torch.ones((4, 2)), td.Hinge(), resume=True,
                            **kw)
    assert r.attempts == (1, 1) and again.resumed_from == 2
    assert r.result.alpha.device.type == "cpu"


def test_serving_runs_on_cpu_when_asked(tmp_path, monkeypatch):
    """Without a card, ``device="cpu"`` boots a snapshot from a
    checkpoint, scores through the engine and fits a trainer, and
    nothing reaches for CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = dense_to_ell(np.eye(4, dtype=np.float32), device="cpu")
    tr = IncrementalTrainer(X, td.Hinge(), epochs=2, device="cpu",
                            solver_kwargs=dict(block_size=2))
    solve_segmented(X, td.Hinge(), epochs=2, checkpoint_every=1,
                    ckpt_dir=str(tmp_path), block_size=2, device="cpu")
    snap = load_snapshot(str(tmp_path), 1, device="cpu")
    eng = ServeEngine(SnapshotStore(snap), k_max=2, trainer=tr,
                      device="cpu")
    t = eng.submit(cols=[0, 3], vals=[1.0, -1.0])
    assert eng.step() == 1
    assert isinstance(t.result(1.0), ScoreOutcome)
    assert tr.fit() is not None and tr.alpha.device.type == "cpu"
    assert snap.w_pad.device.type == "cpu" and not snap.w_pad.is_pinned()


@pytest.mark.parametrize("twin", ["quickstart_torch",
                                  "train_svm_passcode_torch"])
def test_example_twin_runs_on_cpu_without_jax(twin):
    """Each example twin runs end to end with ``--device cpu`` on
    ``tiny`` at 2 epochs, prints finite gaps, and imports neither jax
    nor ``repro``."""
    path = ROOT / "examples" / f"{twin}.py"
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{str(path)!r}, '--device', 'cpu', '--epochs', '2']\n"
        f"runpy.run_path({str(path)!r}, run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('imported:', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    gaps = [float(g) for g in re.findall(r"gap=\s*(\S+)", out.stdout)]
    assert len(gaps) >= 3 and all(np.isfinite(gaps)), out.stdout


def test_probe_twin_runs_on_cpu_without_jax():
    """The linear-probe twin runs end to end with ``--device cpu`` on the
    smoke mistral-nemo-12b (features, the K = 4 multi-task solve, the
    loop over K), beats the majority share on both, and imports neither
    jax nor ``repro``."""
    path = ROOT / "examples" / "linear_probe_lm_torch.py"
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{str(path)!r}, '--device', 'cpu']\n"
        f"runpy.run_path({str(path)!r}, run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('imported:', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    top1 = [float(a) for a in re.findall(r"top1=(\S+)", out.stdout)]
    assert len(top1) == 2 and all(0.0 <= a <= 1.0 for a in top1), out.stdout


@pytest.mark.parametrize("twin,args", [
    ("train_lm_torch", ["--small", "--steps", "40", "--batch", "4",
                        "--seq", "64"]),
    ("serve_lm_torch", ["--requests", "2", "--gen", "6"]),
])
def test_lm_example_twin_runs_on_cpu_without_jax(twin, args, tmp_path):
    """Each LM example twin runs end to end with ``--device cpu`` (the
    train twin's loss falls over 40 steps of the small model, its
    assertion) and imports neither jax nor ``repro``.  Two threads: the
    test workers share the machine's cores."""
    path = ROOT / "examples" / f"{twin}.py"
    if twin == "train_lm_torch":
        args = args + ["--ckpt-dir", str(tmp_path)]
    argv = [str(path), "--device", "cpu", *args]
    code = (
        "import runpy, sys\n"
        f"sys.argv = {argv!r}\n"
        f"runpy.run_path({str(path)!r}, run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('imported:', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "imported: []" in out.stdout
    if twin == "train_lm_torch":
        assert re.search(r"done: loss \S+ → \S+ \(40 steps", out.stdout)
    else:
        assert len(re.findall(r"req\d: \[", out.stdout)) == 2


def test_collectives_import_no_jax():
    """The collective layer of the solver across processes imports
    neither jax nor ``repro``."""
    code = (
        "import sys\n"
        "import repro_torch.dist.collectives\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_fake_mesh_leaves_a_live_gloo_group(tmp_path):
    """``make_fake_mesh`` under a live two-rank ``gloo`` group of another
    size raises and does not replace it: the group still has its two
    ranks and its backend, and still gathers."""
    out = run_world(2, {"fake": {"kind": "fake_mesh"}}, tmp_path)["fake"]
    assert "gloo process group of 2 ranks" in str(out["raised"])
    assert int(out["world"]) == 2 and str(out["backend"]) == "gloo"
    np.testing.assert_array_equal(out["gather"], [0.0, 1.0])
