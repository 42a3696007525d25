"""The 2-D and pod solvers across processes: the ``model``, ``data`` and
``pod`` axes spread over a world of four ``gloo`` ranks, held to the
one-process solve at the same mesh and seed and to the reference's.

One world for the module (``_dist_cases.run_world``) runs every case:

  * (data 1, m 4) with the ``model`` axis over four ranks, and (data 2,
    m 2) and (data 2, m 4) over (data 2 × model 2) ranks — the unfused
    engine (its per-update dot gathered over ``model``), the fused B4 →
    B5 round (B4's partials gathered before their sum, its launch laid
    out for the mesh's m) and the overlapped round; and shrinking with
    repacking at (data 2, m 4) (each row's dot for the mask gathered
    over ``model``, the active count summed over ``data``);
  * the pod solve at (pod 2, data 2) over (pod 2 × data 2) ranks, and on
    the 3-D mesh (pod 2, data 1, m 2) over (pod 2 × model 2).

Each case is bit-equal on α and ŵ to the one-process solve; its gaps
are within C.2's 1e-5 + 1e-6·M of it (a split over ``model`` alone sums
w(α) on one rank's rows, the same bits).  Each is held to the
reference's same-mesh solve at atol 1e-5, gaps at C.2 (pods through
``finalize_on_host``, in ``reference_solves``' child).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.convert import ell_from_numpy
from repro_torch.core import duals as td

from _dist_cases import run_world
from test_torch_shards import case, reference_solves, tiny  # noqa: F401
from test_torch_solver import _assert_result, _gap_atol

EPOCHS, B, SEED = 3, 16, 11
ONE = dict(epochs=EPOCHS, block_size=B, seed=SEED)
ENGINES = {"unfused": dict(use_kernel=False), "fused": dict(use_kernel=True),
           "overlap": dict(use_kernel=True, delay_rounds=1)}
LOSSES = ("hinge", "squared_hinge", "logistic")

CASES, RANKS = {}, {}
for _i, (_eng, _kw) in enumerate(ENGINES.items()):
    for _j, (_p, _m, _ranks) in enumerate([
            (1, 4, {"model": 4}), (2, 2, {"data": 2, "model": 2}),
            (2, 4, {"data": 2, "model": 2})]):
        name = f"d{_p}m{_m}-{_eng}"
        CASES[name] = case(loss=LOSSES[(_i + _j) % 3], p=_p, model=_m,
                           **_kw, **ONE)
        RANKS[name] = _ranks
CASES["d2m4-shrink-repack"] = case(p=2, model=4, shrink_every=1, repack=True,
                                  use_kernel=True, **ONE)
RANKS["d2m4-shrink-repack"] = {"data": 2, "model": 2}
CASES["pods-2x2"] = case(rows=250, pods=2, p=2, pod_delay_rounds=1, **ONE)
RANKS["pods-2x2"] = {"pod": 2, "data": 2}
CASES["pods-2x1m2"] = case(rows=250, loss="logistic", pods=2, p=1, model=2,
                           **ONE)
RANKS["pods-2x1m2"] = {"pod": 2, "model": 2}
# the placement of a rank's part: its feature shards, its data shards'
# feature shards, and its pod's feature shards
PLACED = ("d1m4-fused", "d2m4-fused", "pods-2x1m2")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    spec = {name: {"kind": "solve", "case": c, "ranks": RANKS[name]}
            for name, c in CASES.items()}
    spec.update({f"place-{name}": {"kind": "placement", "case": CASES[name],
                                   "ranks": RANKS[name]} for name in PLACED})
    return run_world(4, spec, tmp_path_factory.mktemp("dist2d"))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_solves(CASES, tmp_path_factory.mktemp("ref_dist2d"))


def _X(tiny, c):  # noqa: F811
    idx, val, d, _ = tiny
    return ell_from_numpy(idx[:c["rows"]], val[:c["rows"]], d, device="cpu")


def _result(out, prefix):
    return types.SimpleNamespace(**{
        k: torch.from_numpy(out[f"{prefix}_{k}"])
        for k in ("alpha", "w_hat", "gaps", "eps", "active", "delay")})


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_are_the_one_process_solve(world, tiny, name):
    c, out = CASES[name], world[name]
    for k in ("alpha", "w_hat", "active", "delay"):
        np.testing.assert_array_equal(out[f"dist_{k}"], out[f"one_{k}"])
    one = _result(out, "one")
    tol = _gap_atol(_X(tiny, c), one.alpha, td.make_loss(c["loss"]))
    np.testing.assert_allclose(out["dist_gaps"], out["one_gaps"], rtol=0,
                               atol=tol)
    np.testing.assert_allclose(out["dist_eps"], out["one_eps"], rtol=0,
                               atol=1e-5)
    if "data" not in RANKS[name] and "pod" not in RANKS[name]:
        # w(α) on every rank's rows: the records are the same bits
        np.testing.assert_array_equal(out["dist_gaps"], out["one_gaps"])


@pytest.mark.parametrize("name", PLACED)
def test_a_rank_places_only_its_part(world, name):
    """A rank's placed slices are a quarter of the one-process split, in
    storage of their own (never a view of the caller's X)."""
    out = world[f"place-{name}"]
    for nbytes, storage, shared in out["ranks"]:
        assert 4 * nbytes == out["one"]
        assert storage == nbytes and not shared


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_reference(world, ref, tiny, name):
    c = CASES[name]
    _assert_result(_result(world[name], "dist"),
                   types.SimpleNamespace(**ref[name]), _X(tiny, c),
                   td.make_loss(c["loss"]))
