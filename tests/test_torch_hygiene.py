"""The port stands alone: no ``repro_torch`` module imports jax or the
JAX package ``repro``, and its entry points run on the card unless the
caller asks for the CPU — without a card they raise, never carry on."""

import os
import pkgutil
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
    w2d_from_numpy,
)
from repro_torch.core import duals as td
from repro_torch.core.dcd import dcd_solve
from repro_torch.core.sharded import sharded_passcode_solve
from repro_torch.data.sparse import dense_to_ell
from repro_torch.data.synthetic import make_dataset, make_paper_split
from repro_torch.dist.mesh import solver_mesh_2d

SRC = Path(__file__).resolve().parents[1] / "src"


def test_no_module_imports_jax_or_repro():
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    assert "repro_torch.core.sharded" in mods and len(mods) >= 15
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
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_raise_without_it(name,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
