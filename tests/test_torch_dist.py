"""The 1-D solver across processes: the ``data`` and ``pod`` axes spread
over a world of two ``gloo`` ranks (``repro_torch.dist.mesh.with_ranks``,
``repro_torch.dist.collectives``), held to the one-process solve at the
same mesh and seed and to the reference's.

One world for the module (``_dist_cases.run_world``: ranks from
``torch.multiprocessing.spawn``, a ``file://`` store under the test's
temporary directory) runs every case; rank 0 also runs the one-process
solve.  Each case is bit-equal on α and ŵ to the one-process solve, its
gap records within C.2's 1e-5 + 1e-6·M (the CPU's w(α) is a float
scatter, summed over the ranks' partials), its active fractions and
delay flags equal; and it is held to the reference's same-mesh solve
(``test_torch_shards.reference_solves``; pod cases through
``finalize_on_host``, which that child applies) at atol 1e-5, gaps at
C.2.  The collective layer's order, SUM, MAX and the rank layout's
errors run in the same world.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.convert import dense_from_numpy, ell_from_numpy
from repro_torch.core import duals as td

from _dist_cases import run_world
from test_torch_shards import case, reference_solves, tiny  # noqa: F401
from test_torch_solver import _assert_result, _assert_tasks, _fold, _gap_atol

EPOCHS, B, SEED = 4, 8, 11
ONE = dict(epochs=EPOCHS, block_size=B, seed=SEED)
_Y3 = (np.stack([np.arange(250) % 3 == k for k in range(3)]) * 2.0
       - 1.0).tolist()

CASES = {}
for _dense in (False, True):
    for _dr, _loss in ((0, "hinge"), (1, "squared_hinge")):
        CASES[f"{'dense' if _dense else 'ell'}-p4-d{_dr}"] = case(
            dense=_dense, loss=_loss, p=4, delay_rounds=_dr, **ONE)
CASES.update({
    "ell-p4-n250-logistic": case(rows=250, loss="logistic", p=4, **ONE),
    "shrink-repack": case(p=4, shrink_every=1, repack=True,
                          repack_threshold=0.9, **ONE),
    "adaptive": case(p=4, adaptive=True, delay_rounds=1,
                     adaptive_ratio=0.5, **ONE),
    "tasks-k3": case(rows=250, p=4, Y=_Y3, delay_rounds=1, **ONE),
    "pods-2x2": case(rows=250, pods=2, p=2, pod_delay_rounds=1, **ONE),
    "pods-2x1-dense": case(rows=250, dense=True, pods=2, p=1, **ONE),
})
RANKS = {name: {"pod": 2} if c.get("pods") else {"data": 2}
         for name, c in CASES.items()}
# shrinking at B = 8 flips a row of the mask between the reference's own
# ELL and dense engines (ROADMAP C.18): the case is held to either
SHRINK = {"shrink-repack"}
REF_CASES = {**CASES, **{f"{name}~dense": dict(CASES[name], dense=True)
                         for name in SHRINK}}
# the per-epoch host driver (pipeline=False) goes through the same sites;
# the reference's own driver raises on the installed jax (ROADMAP C.4)
DRIVER = {"driver-ell-d1": case(p=4, delay_rounds=1, pipeline=False, **ONE)}
# a rank whose shards are all padding (3 rows over p = 8: rank 1 holds
# none), held to the one-process solve only
PADDING = {f"{kind}-p8-n3-padding-rank": case(rows=3, dense=kind == "dense",
                                              p=8, **ONE)
           for kind in ("ell", "dense")}
# the placement of a rank's part: ELL, dense, and one pod a rank
PLACED = ("ell-p4-d0", "dense-p4-d0", "pods-2x2")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    spec = {name: {"kind": "solve", "case": c, "ranks": RANKS.get(
        name, {"data": 2})} for name, c in {**CASES, **DRIVER,
                                            **PADDING}.items()}
    spec["collectives"] = {"kind": "collectives"}
    spec.update({f"place-{name}": {"kind": "placement", "case": CASES[name],
                                   "ranks": RANKS[name]} for name in PLACED})
    return run_world(2, spec, tmp_path_factory.mktemp("dist"))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_solves(REF_CASES, tmp_path_factory.mktemp("ref_dist"))


def _port_X(tiny, c):  # noqa: F811
    idx, val, d, dense_X = tiny
    r = c["rows"]
    if c["dense"]:
        return dense_from_numpy(dense_X[:r], device="cpu")
    return ell_from_numpy(idx[:r], val[:r], d, device="cpu")


def _result(out, prefix):
    return types.SimpleNamespace(**{
        k: torch.from_numpy(out[f"{prefix}_{k}"])
        for k in ("alpha", "w_hat", "gaps", "eps", "active", "delay")
        if f"{prefix}_{k}" in out})


def _assert_bits(out, Xp, loss, Y=None):
    """α and ŵ bit for bit, the records at C.2, the flags equal."""
    for k in ("alpha", "w_hat", "active", "delay"):
        if f"one_{k}" in out:  # the host driver records gaps only
            np.testing.assert_array_equal(out[f"dist_{k}"], out[f"one_{k}"])
    one = _result(out, "one")
    rows = [(one.alpha, Xp)] if Y is None else [
        (one.alpha[k], _fold(Xp, torch.from_numpy(Y[k])))
        for k in range(len(Y))]
    gaps = out["dist_gaps"].reshape(len(rows), -1)
    want = out["one_gaps"].reshape(len(rows), -1)
    for (alpha, Xk), g, w in zip(rows, gaps, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=_gap_atol(Xk, alpha, loss))
    if "one_eps" in out:
        np.testing.assert_allclose(out["dist_eps"], out["one_eps"], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("name", list(CASES) + list(DRIVER) + list(PADDING))
def test_two_ranks_are_the_one_process_solve(world, tiny, name):
    c = {**CASES, **DRIVER, **PADDING}[name]
    out = world[name]
    Y = None if c["Y"] is None else np.asarray(c["Y"], np.float32)
    _assert_bits(out, _port_X(tiny, c), td.make_loss(c["loss"]), Y)
    assert np.isfinite(out["dist_gaps"]).all()


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_reference(world, ref, tiny, name):
    c = CASES[name]
    Xp, loss = _port_X(tiny, c), td.make_loss(c["loss"])
    p = _result(world[name], "dist")
    if name in SHRINK:
        errors = []
        for kind in (name, f"{name}~dense"):
            try:
                _assert_result(p, types.SimpleNamespace(**ref[kind]), Xp,
                               loss)
                return
            except AssertionError as err:
                errors.append(f"{kind}: {err}")
        raise AssertionError("matches neither reference engine:\n"
                             + "\n".join(errors))
    if c["Y"] is None:
        _assert_result(p, types.SimpleNamespace(**ref[name]), Xp, loss)
    else:
        _assert_tasks(p, types.SimpleNamespace(**ref[name]), Xp, c["Y"],
                      loss)


@pytest.mark.parametrize("name", PLACED)
def test_a_rank_places_only_its_part(world, name):
    """A rank's placed X is its half of the one-process placement, in
    storage of its own: no view of the caller's X (which would keep the
    whole X alive wherever it lies) and no copy of the rest."""
    out = world[f"place-{name}"]
    for nbytes, storage, shared in out["ranks"]:
        assert 2 * nbytes == out["one"]
        assert storage == nbytes and not shared


def test_collectives_order_sum_max(world):
    """``gather_axis`` concatenates in rank order on the dimension asked
    for, ``sum_int`` adds int64 exactly past 2^32, ``max_all`` takes the
    max, a virtual axis is the identity, and rank 0's span is the first
    half of the axis."""
    out = world["collectives"]
    np.testing.assert_array_equal(out["order"], [0, 0, 1, 1])
    np.testing.assert_array_equal(out["order_dim1"], [[0, 1], [0, 1]])
    np.testing.assert_array_equal(out["sum"], [3, 2**41 + 1])
    assert out["sum"].dtype == np.int64
    np.testing.assert_array_equal(out["max"], [1.0, 0.0])
    np.testing.assert_array_equal(out["virtual"], [0.0, 0.0])
    np.testing.assert_array_equal(out["span"], [0, 2])


def test_rank_layout_errors(world):
    """A float SUM is refused; an axis that does not divide over its
    ranks raises a ValueError naming both sizes, whether the ranks are
    asked for (``with_ranks``) or come with a ``DeviceMesh``
    (``rank_layout``)."""
    errors = [str(e) for e in world["collectives"]["errors"]]
    assert "int64" in errors[0]
    for msg, shards in zip(errors[1:], (3, 3)):
        assert f"{shards} shards" in msg and "2 ranks" in msg


def test_no_layout_without_ranks():
    """Without a process group every mesh keeps the one-process path:
    no layout, and the collectives are the identity."""
    from repro_torch.dist import collectives as tc
    from repro_torch.dist.mesh import rank_layout, solver_mesh, solver_mesh_2d

    assert rank_layout(solver_mesh(n_devices=4)) is None
    assert rank_layout(solver_mesh_2d(data=2, model=2)) is None
    assert solver_mesh() == solver_mesh(n_devices=1)
    t = torch.arange(3)
    assert tc.gather_axis(t, None, "data") is t
    assert tc.sum_int(t, None) is t
    assert tc.max_all(t, None) is t
