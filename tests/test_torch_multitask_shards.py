"""The multi-task solve over p > 1 data shards, on the 2-D mesh at
data = 2 and on a ``task`` mesh, against the reference's on 8 fake CPU
devices (the reference in one child process per module,
``test_torch_shards.reference_solves``).

Cases (K one-vs-rest classes of ``tiny``'s first rows, ids drawn from a
seed): ELL at p = 2 with n = 249 (p ∤ n) with shrinking and repacking
(each task its own masked draw and round count), dense at p = 4 with
n = 250 and an adaptive delay (each task its own latch), ELL at p = 4
with a fixed delay, the 2-D mesh at data = 2, m = 2 (the port's fused
round overlapped with delay_rounds = 1; the reference's unfused engine
computes the same updates), and ``solver_mesh_tasks(task=2, data=4)``,
whose task shards the reference spreads over devices and the port runs
as one task dimension.  Tolerances as ``test_torch_shards``, class by
class (``test_torch_solver._assert_tasks``).
"""

import numpy as np
import pytest

from repro_torch.core import duals as td
from repro_torch.core import sharded as ts
from repro_torch.dist.mesh import solver_mesh, solver_mesh_2d, \
    solver_mesh_tasks

from test_torch_shards import case, port_X, reference_solves, tiny  # noqa: F401
from test_torch_solver import _assert_tasks

EPOCHS, B, SEED = 3, 8, 13


def _labels(rows, K, seed):
    """A (K, rows) ±1 one-vs-rest matrix of ids drawn from ``seed``."""
    ids = np.random.default_rng(seed).integers(0, K, rows)
    return np.where(ids[None] == np.arange(K)[:, None], 1.0, -1.0).astype(
        np.float32)


CASES = {
    "ell-p2-n249-shrink-repack": case(
        rows=249, p=2, Y=_labels(249, 3, 0).tolist(), epochs=EPOCHS,
        block_size=B, seed=SEED, shrink_every=1, repack=True,
        repack_threshold=0.9),
    "dense-p4-n250-adaptive": case(
        rows=250, dense=True, loss="squared_hinge", p=4,
        Y=_labels(250, 3, 1).tolist(), epochs=EPOCHS, block_size=B,
        seed=SEED, adaptive=True, delay_rounds=1, adaptive_ratio=0.5),
    "ell-p4-n250-delay-logistic": case(
        rows=250, loss="logistic", p=4, Y=_labels(250, 4, 2).tolist(),
        epochs=EPOCHS, block_size=B, seed=SEED, delay_rounds=1),
    "2d-data2-m2": case(
        rows=250, p=2, model=2, Y=_labels(250, 3, 3).tolist(),
        epochs=EPOCHS, block_size=16, seed=SEED, delay_rounds=1),
    "task2-data4": case(
        rows=250, p=4, task=2, Y=_labels(250, 4, 4).tolist(), epochs=EPOCHS,
        block_size=B, seed=SEED),
}
# what the port runs beyond the reference's keywords: the fused 2-D round
# (overlapped, with delay_rounds = 1) where the reference ran its unfused
# engine
PORT_KW = {"2d-data2-m2": dict(use_kernel=True)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_solves(CASES, tmp_path_factory.mktemp("ref_multitask"))


def _mesh(c):
    if c["task"]:
        return solver_mesh_tasks(task=c["task"], data=c["p"],
                                 model=c["model"] or 1)
    if c["model"]:
        return solver_mesh_2d(data=c["p"], model=c["model"])
    return solver_mesh(n_devices=c["p"])


@pytest.mark.parametrize("name", list(CASES))
def test_multitask_shards_match_reference(ref, tiny, name):
    c = CASES[name]
    Xp = port_X(tiny, c["rows"], c["dense"])
    loss = td.make_loss(c["loss"])
    Y = np.asarray(c["Y"], np.float32)
    kw = dict(c["kw"], **PORT_KW.get(name, {}))
    mesh = _mesh(c)
    setup = ts.prepare_solver(Xp, loss, mesh=mesh, y=Y, device="cpu",
                              **{k: v for k, v in kw.items()
                                 if k != "epochs"})
    assert (setup.p, setup.n_tasks) == (c["p"], Y.shape[0])
    if name == "2d-data2-m2":
        assert setup.fused and setup.overlap
    res = ts.sharded_passcode_solve(Xp, loss, mesh=mesh, y=Y, device="cpu",
                                    **kw)
    r = ref[name]
    assert res.alpha.shape == r["alpha"].shape == (Y.shape[0], c["rows"])
    _assert_tasks(res, type("R", (), r), Xp, Y, loss)
    if name.startswith("ell-p2"):
        # the tasks' own round counts, read together once an epoch
        rounds = ts.sharded_passcode_solve.task_rounds
        assert len(rounds) == EPOCHS and all(len(k) == 3 for k in rounds)


def test_task_mesh_solve_equals_plain_mesh(tiny):
    """On one card the task shards are virtual: the ``task`` mesh's solve
    is the plain mesh's at the same data size, bit for bit."""
    c = CASES["task2-data4"]
    Xp = port_X(tiny, c["rows"], False)
    Y = np.asarray(c["Y"], np.float32)
    a = ts.sharded_passcode_solve(Xp, td.Hinge(), mesh=_mesh(c), y=Y,
                                  device="cpu", **c["kw"])
    b = ts.sharded_passcode_solve(Xp, td.Hinge(),
                                  mesh=solver_mesh(n_devices=c["p"]), y=Y,
                                  device="cpu", **c["kw"])
    np.testing.assert_array_equal(a.alpha.numpy(), b.alpha.numpy())
    np.testing.assert_array_equal(a.w_hat.numpy(), b.w_hat.numpy())
