"""The incremental trainer's re-solve across processes (ROADMAP A.13c):
``IncrementalTrainer`` with ``solver_kwargs`` holding a mesh spread over
two ``gloo`` ranks (``with_ranks``) fits, ingests a drift-free and a
drifted chunk, trips drift and re-solves warm, as the one-process
trainer on the same mesh does.

One world for the module (``_dist_cases.run_world``, kind ``trainer``),
the binary case of ``test_torch_serve``'s trainer parity test.  Held:

  * to the one-process trainer on the same mesh: each solve's α and ŵ
    and the published snapshot's ``w_pad`` (from the gathered ŵ) bit for
    bit, ``err_base``, the ledger and the ``drifted()`` answers equal;
    the gap records within C.2 where the ``data`` axis is spread (a
    W-rank w(α) sums the ranks' float scatters in rank order on the
    CPU, ROADMAP C.19), bit for bit over ``model`` ranks;
  * over two ``model`` ranks — the 2-D solve at data = 1, whose block
    schedule is the one-device solve's — to the reference's trainer on
    one device: α and ŵ at atol 1e-5, the gaps at 1e-5 + 1e-6·M (C.2),
    the ledger, ``err_base`` and the ``drifted()`` answers.

The engine's scoring stays on one process (the reference's
``ServeEngine`` has no mesh).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.duals import Hinge
from repro_torch.data.sparse import EllMatrix

from _dist_cases import run_world
from test_torch_serve import _run_trainer, _trainer_case
from test_torch_shards import case
from test_torch_solver import ATOL, _gap_atol

RUNS = {
    "data-p4": dict(case=case(p=4), ranks={"data": 2}),
    "model-m2": dict(case=case(p=1, model=2), ranks={"model": 2}),
}
FIELDS = ("alpha", "w_hat")


def _inputs():
    c = _trainer_case(0)
    return {"X0": c["X0"].tolist(),
            "chunks": [[X.tolist(), y.tolist()] for X, y in c["chunks"]]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    spec = {name: dict(kind="trainer", inputs=_inputs(), **run)
            for name, run in RUNS.items()}
    return run_world(2, spec, tmp_path_factory.mktemp("dist_trainer"))


@pytest.fixture(scope="module")
def reference():
    return _run_trainer("ref", 0)


def _X(out, run, rows=None):
    idx = torch.from_numpy(out[f"{run}_X_indices"])
    val = torch.from_numpy(out[f"{run}_X_values"])
    if rows is not None:
        idx, val = idx[:rows], val[:rows]
    return EllMatrix(idx, val, 16)


@pytest.mark.parametrize("name", list(RUNS))
def test_two_rank_trainer_is_the_one_process_trainer(world, name):
    out = world[name]
    for key in ("X_indices", "X_values", "w_pad", "err_base", "ledger",
                "drifted"):
        np.testing.assert_array_equal(out[f"dist_{key}"], out[f"one_{key}"])
    assert out["one_drifted"].tolist() == [False, True]
    spread_rows = "data" in RUNS[name]["ranks"]
    for solve, rows in (("fit", 64), ("res", None)):
        for k in FIELDS:
            np.testing.assert_array_equal(out[f"dist_{solve}_{k}"],
                                          out[f"one_{solve}_{k}"])
        got, want = out[f"dist_{solve}_gaps"], out[f"one_{solve}_gaps"]
        if spread_rows:
            tol = _gap_atol(_X(out, "one", rows),
                            torch.from_numpy(out[f"one_{solve}_alpha"]),
                            Hinge(C=1.0))
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(got, want)
    # the snapshot is published from the gathered ŵ
    w = out["dist_res_w_hat"]
    np.testing.assert_array_equal(out["dist_w_pad"][:w.shape[0]], w)


def test_two_model_ranks_match_the_reference_trainer(world, reference):
    out, r = world["model-m2"], reference
    assert out["dist_drifted"].tolist() == r["drifted"]
    ledger = r["tr"].ledger
    np.testing.assert_array_equal(out["dist_ledger"],
                                  [ledger[k] for k in sorted(ledger)])
    assert float(out["dist_err_base"]) == pytest.approx(r["err_base"],
                                                        abs=1e-12)
    np.testing.assert_array_equal(out["dist_X_indices"],
                                  np.asarray(r["tr"].X.indices))
    np.testing.assert_array_equal(out["dist_X_values"],
                                  np.asarray(r["tr"].X.values))
    for solve, rows in (("fit", 64), ("res", None)):
        rr = r[solve].result
        for k in FIELDS:
            np.testing.assert_allclose(out[f"dist_{solve}_{k}"],
                                       np.asarray(getattr(rr, k)), rtol=0,
                                       atol=ATOL)
        tol = _gap_atol(_X(out, "dist", rows),
                        torch.from_numpy(out[f"dist_{solve}_alpha"]),
                        Hinge(C=1.0))
        np.testing.assert_allclose(out[f"dist_{solve}_gaps"],
                                   np.asarray(rr.gaps), rtol=0, atol=tol)
