"""The slice as a whole: ``repro_torch`` ``sharded_passcode_solve`` and
``dcd_solve`` against ``repro.core`` on the same data and the same
update schedule.

Each test replays the reference's key chain — ``key = PRNGKey(seed)``,
then per epoch ``key, sub = split(key)`` — through
``repro.core.sharded._masked_block_perms`` (or ``permutation`` for the
serial solver) and passes the draws to the port as ``blocks=`` /
``perms=``, so these cases hold the engines to the reference whatever
the draw; ``test_torch_prng.py`` holds the port's own seeded draw to the
same chain.

Tolerances: atol 1e-5 on α, ŵ and ‖w(α) − ŵ‖.  The duality gap is a
float32 sum over n rows that the two frameworks add in other orders, and
it cancels: P and D are each about M/2, where M = ‖w(α)‖² + Σ|ℓ| + Σ|ℓ*|
is often 100× the gap (the reference's own ELL and dense paths differ by
1.4e-5 on one solve).  So the gap is held at atol 1e-5 + 1e-6·M, about
17 float32 ulps of M, with M taken in float64 from the final α.
"""

import types

import jax
import numpy as np
import pytest
import torch

from repro.core import dcd_solve as jax_dcd_solve
from repro.core import duals as rd
from repro.core import sharded as rs
from repro.data import make_dataset
from repro_torch.convert import (
    dense_from_numpy,
    ell_from_numpy,
    state_from_numpy,
)
from repro_torch.core import duals as td
from repro_torch.core.dcd import dcd_solve
from repro_torch.core.objective import _matvec, w_of_alpha
from repro_torch.data.sparse import EllMatrix
from repro_torch.core.sharded import prepare_solver, sharded_passcode_solve
from repro_torch.dist.mesh import solver_mesh_2d

ATOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    ds = make_dataset("tiny")
    X = ds.X_train
    return (X, np.asarray(X.indices), np.asarray(X.values), X.n_features,
            np.asarray(X.to_dense()))


def _ref_blocks(seed, epochs, n, B):
    nb = rs._n_blocks(n, B)
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        out.append(np.asarray(
            rs._masked_block_perms(sub, 1, n, n, nb, B)).reshape(nb, B))
    return np.stack(out)


def _ref_perms(seed, epochs, n):
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.permutation(sub, n)))
    return np.stack(out)


def _port_X(tiny, ell):
    _, idx, val, d, dense = tiny
    if ell:
        return ell_from_numpy(idx, val, d, device="cpu")
    return dense_from_numpy(dense, device="cpu")


def _gap_atol(Xp, alpha, loss):
    """atol 1e-5 + 1e-6·M for a gap at α, M the magnitude it cancels."""
    X64 = (EllMatrix(Xp.indices, Xp.values.double(), Xp.n_features)
           if isinstance(Xp, EllMatrix) else Xp.double())
    a = alpha.double()
    wa = w_of_alpha(X64, a)
    M = (torch.dot(wa, wa) + loss.primal_loss(_matvec(X64, wa)).abs().sum()
         + loss.conj(a).abs().sum())
    return ATOL + 1e-6 * float(M)


def _fold(Xp, y):
    """The rows of ``Xp`` (dense or ELL) times ±1 labels ``y``."""
    if isinstance(Xp, EllMatrix):
        return EllMatrix(Xp.indices, Xp.values * y[:, None], Xp.n_features)
    return Xp * y[:, None]


def _assert_tasks(p, r, Xp, Y, loss, *, metrics=True):
    """A multi-task result against the reference's, class by class
    (``_assert_result`` on class k's slices, its gap tolerance from the
    rows folded by ``Y[k]``).  The active fraction count/n is held to
    one float32 rounding: under its task vmap the reference's XLA
    divides by the constant n as a product with 1/n, a rounding off the
    correctly rounded quotient (56/96: 0.5833334 against 0.5833333);
    the delay flags are held equal."""
    Y = torch.as_tensor(np.array(Y), dtype=torch.float32)
    assert p.alpha.shape == tuple(np.asarray(r.alpha).shape)
    keys = ("alpha", "w_hat", "gaps", "eps", "active", "delay")
    for k in range(Y.shape[0]):
        pk = types.SimpleNamespace(**{f: getattr(p, f)[k] for f in keys})
        rk = types.SimpleNamespace(**{f: np.asarray(getattr(r, f))[k]
                                      for f in keys})
        if metrics:
            np.testing.assert_allclose(pk.active.numpy(), rk.active,
                                       rtol=2.0 ** -23, atol=0)
            rk.active = pk.active.numpy()
        _assert_result(pk, rk, _fold(Xp, Y[k]), loss, metrics=metrics)


def _assert_result(p, r, Xp, loss, *, metrics=True):
    for port, ref in [(p.alpha, r.alpha), (p.w_hat, r.w_hat)]:
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(p.gaps.numpy(), np.asarray(r.gaps), rtol=0,
                               atol=_gap_atol(Xp, p.alpha, loss))
    if metrics:
        np.testing.assert_allclose(p.eps.numpy(), np.asarray(r.eps), rtol=0,
                                   atol=ATOL)
        np.testing.assert_array_equal(p.active.numpy(), np.asarray(r.active))
        np.testing.assert_array_equal(p.delay.numpy(), np.asarray(r.delay))


# (ell, loss, delay_rounds, gap_every, reference use_kernel, port use_kernel)
CASES = [
    (ell, loss, dr, ge, False, "auto")
    for ell in (True, False)
    for loss in ("hinge", "squared_hinge", "logistic")
    for dr, ge in ((0, 1), (1, 3))
] + [
    (True, "hinge", 0, 3, True, True),
    (True, "logistic", 1, 1, True, True),
    (False, "squared_hinge", 1, 1, True, True),
    (False, "logistic", 0, 3, True, True),
]


@pytest.mark.parametrize(
    "ell,loss,delay_rounds,gap_every,ref_kernel,port_kernel", CASES,
    ids=[f"{'ell' if c[0] else 'dense'}-{c[1]}-d{c[2]}-g{c[3]}-k{int(c[4])}"
         for c in CASES])
def test_solve_matches_reference(tiny, ell, loss, delay_rounds, gap_every,
                                 ref_kernel, port_kernel):
    X, *_, dense = tiny
    kw = dict(epochs=3, block_size=32, delay_rounds=delay_rounds,
              gap_every=gap_every, seed=5)
    r = rs.sharded_passcode_solve(X if ell else dense, rd.make_loss(loss),
                                  use_kernel=ref_kernel, **kw)
    Xp, lossp = _port_X(tiny, ell), td.make_loss(loss)
    p = sharded_passcode_solve(Xp, lossp, use_kernel=port_kernel,
                               device="cpu",
                               blocks=_ref_blocks(5, 3, 256, 32), **kw)
    assert p.rounds == 3 and p.gaps.shape == r.gaps.shape
    _assert_result(p, r, Xp, lossp)


def test_tail_block_and_label_fold_match_reference(tiny):
    """n = 101 with B = 16: the last block cycles through the draw's
    front.  The labels arrive unfolded and fold at the mouth."""
    _, _, _, _, dense = tiny
    X = dense[:101]
    y = np.where(np.arange(101) % 3 == 0, -1.0, 1.0).astype(np.float32)
    raw = X * y[:, None]  # unfolded rows: y·raw is the folded X again
    kw = dict(epochs=2, block_size=16, seed=1)
    r = rs.sharded_passcode_solve(raw, rd.Hinge(), y=y, **kw)
    p = sharded_passcode_solve(dense_from_numpy(raw, device="cpu"),
                               td.Hinge(), y=torch.from_numpy(y),
                               device="cpu", blocks=_ref_blocks(1, 2, 101, 16),
                               **kw)
    _assert_result(p, r, dense_from_numpy(X, device="cpu"), td.Hinge())
    folded = sharded_passcode_solve(dense_from_numpy(X, device="cpu"),
                                    td.Hinge(), device="cpu",
                                    blocks=_ref_blocks(1, 2, 101, 16), **kw)
    np.testing.assert_array_equal(folded.alpha.numpy(), p.alpha.numpy())


def test_warm_start_matches_reference(tiny):
    X, *_ = tiny
    rng = np.random.default_rng(0)
    a0 = rng.uniform(0, 0.5, 200).astype(np.float32)  # shorter than n
    w0 = (rng.standard_normal(128) * 0.05).astype(np.float32)
    kw = dict(epochs=2, block_size=64, seed=2)
    r = rs.sharded_passcode_solve(X, rd.Hinge(), alpha0=a0, w0=w0, **kw)
    pa0, pw0 = state_from_numpy(a0, w0, device="cpu")
    Xp = _port_X(tiny, True)
    p = sharded_passcode_solve(Xp, td.Hinge(), alpha0=pa0, w0=pw0,
                               device="cpu",
                               blocks=_ref_blocks(2, 2, 256, 64), **kw)
    _assert_result(p, r, Xp, td.Hinge())


def test_record_off_and_own_draw(tiny):
    """record=False records nothing; the port's own seeded draw is the
    reference's key chain: a seed alone runs exactly the updates of the
    reference's schedule for that seed."""
    Xp = _port_X(tiny, True)
    p = sharded_passcode_solve(Xp, td.Hinge(), epochs=2, block_size=64,
                               record=False, device="cpu")
    assert p.gaps.shape == (0,) and p.eps.shape == (0,)
    a = sharded_passcode_solve(Xp, td.Hinge(), epochs=2, block_size=64,
                               seed=9, device="cpu")
    b = sharded_passcode_solve(Xp, td.Hinge(), epochs=2, block_size=64,
                               seed=9, device="cpu",
                               blocks=_ref_blocks(9, 2, 256, 64))
    np.testing.assert_array_equal(a.alpha.numpy(), b.alpha.numpy())
    np.testing.assert_array_equal(a.w_hat.numpy(), b.w_hat.numpy())
    assert float(a.gaps[-1]) < float(a.gaps[0])


@pytest.mark.parametrize("ell", [True, False], ids=["ell", "dense"])
@pytest.mark.parametrize("loss", ["hinge", "logistic"])
def test_dcd_solve_matches_reference(tiny, ell, loss):
    X, *_, dense = tiny
    r = jax_dcd_solve(X if ell else dense, rd.make_loss(loss), epochs=3,
                      seed=4)
    Xp, lossp = _port_X(tiny, ell), td.make_loss(loss)
    p = dcd_solve(Xp, lossp, epochs=3, perms=_ref_perms(4, 3, 256),
                  device="cpu")
    np.testing.assert_allclose(p.alpha.numpy(), np.asarray(r.alpha), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(p.w.numpy(), np.asarray(r.w), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(p.gaps.numpy(), np.asarray(r.gaps), rtol=0,
                               atol=_gap_atol(Xp, p.alpha, lossp))
    assert p.epochs == r.epochs == 3


# ----------------------------------------------------------- the mouth


def _bad(kind):
    X = torch.ones((8, 3))
    if kind == "C":
        return dict(X_host=X, loss=td.Hinge(C=0.0))
    if kind == "nan":
        X[2, 1] = float("nan")
        return dict(X_host=X, loss=td.Hinge())
    if kind == "labels":
        return dict(X_host=X, loss=td.Hinge(), y=torch.full((8,), 2.0))
    if kind == "n_labels":
        return dict(X_host=X, loss=td.Hinge(), y=torch.ones(7))
    if kind == "blocks_shape":
        return dict(X_host=X, loss=td.Hinge(), blocks=np.zeros((1, 2, 2)))
    if kind == "blocks_range":
        return dict(X_host=X, loss=td.Hinge(), block_size=4,
                    blocks=np.full((1, 2, 4), 8))
    if kind == "use_kernel":
        return dict(X_host=X, loss=td.Hinge(), use_kernel="sometimes")
    if kind == "plain_on_cuda":
        return dict(X_host=X, loss=td.Hinge(), use_kernel=False,
                    device="cuda")
    return dict(X_host=X, loss=td.Hinge(), block_size=0)


@pytest.mark.parametrize("kind", ["C", "nan", "labels", "n_labels",
                                  "blocks_shape", "blocks_range",
                                  "block_size", "use_kernel"])
def test_validation_errors(kind):
    kw = _bad(kind)
    kw.setdefault("device", "cpu")
    with pytest.raises(ValueError):
        sharded_passcode_solve(kw.pop("X_host"), kw.pop("loss"), epochs=1,
                               **kw)


def test_dcd_solve_rejects_bad_perms():
    X = torch.ones((4, 2))
    for perms in (np.zeros((2, 4)), np.full((1, 4), 4)):
        with pytest.raises(ValueError, match="perms"):
            dcd_solve(X, td.Hinge(), epochs=1, perms=perms, device="cpu")


TWO_D = dict(mesh=solver_mesh_2d(model=2))
ACTS = "acts"  # the knob is ported: it acts as the reference's does
ONES = np.ones((8, 3), np.float32)  # the rows the raising cases are given

# (knob, the ROADMAP item that names it, what it does in the port): the
# self-tuning knobs (A.7 on the 1-D mesh, A′.2 on the 2-D mesh), p > 1
# data shards (A′.1), multi-task labels (A.9: a (K, n) y acts on
# ``ONES``, a 'task' axis without one raises the reference's ValueError)
# and pods (A.10: a 'pod' axis acts, pod_delay_rounds without one raises
# the reference's ValueError) act, and so does pipeline=False (A′.12, the
# per-epoch host driver, held to the reference's pipelined solve)
KNOBS = [
    (dict(shrink_every=1), "A.7", ACTS),
    (dict(repack=True), "A.7", ValueError),  # without shrink_every
    (dict(adaptive=True), "A.7", ACTS),
    (dict(pod_delay_rounds=1), "A.10", ValueError),
    (dict(mesh_axes=("pod", "data")), "A.10", ACTS),
    (dict(mesh=solver_mesh_2d(data=2, model=2)), "A′.1", ACTS),
    (dict(overlap=True), "2-D", ValueError),
    (dict(mesh_axes=("task", "data")), "A.9", ValueError),
    (dict(y=np.ones((2, 8), np.float32)), "A.9", ACTS),
    (dict(TWO_D, shrink_every=1), "A′.2", ACTS),
    (dict(TWO_D, adaptive=True), "A′.2", ACTS),
    (dict(pipeline=False), "A′.12", ACTS),
    # the reference's tuning values act only with their knob on
    (dict(shrink_every=2, shrink_tol=1e-2), "A.7", ACTS),
    (dict(shrink_every=1, repack=True, repack_threshold=0.3), "A.7", ACTS),
    (dict(adaptive=True, adaptive_ratio=0.5), "A.7", ACTS),
    (dict(TWO_D, adaptive=True, adaptive_ratio=0.5), "A′.2", ACTS),
]
KNOB_SOLVE = dict(epochs=3, block_size=32, seed=5)


def _reference_knob(knob):
    """``knob`` as the reference takes it: its ``mesh_axes`` path with a
    'task' axis names ``solver_mesh_tasks`` without importing it
    (``repro/core/sharded.py:1885``, a NameError; ROADMAP C.7), so it is
    handed the mesh that path builds on one device, every axis of size
    1."""
    axes = knob.get("mesh_axes", ())
    if "task" not in axes:
        return knob
    kw = {k: v for k, v in knob.items() if k != "mesh_axes"}
    return dict(kw, mesh=jax.make_mesh((1,) * len(axes), tuple(axes)))


@pytest.fixture(scope="module")
def ref_data_shards(tmp_path_factory):
    """The reference's solve of knob 5 (data = 2, model = 2) on 4 fake
    devices, in a child process (``test_torch_shards.reference_solves``)."""
    from test_torch_shards import case, reference_solves
    return reference_solves(
        {"knob5": case(p=2, model=2, **KNOB_SOLVE)},
        tmp_path_factory.mktemp("ref_knobs"))["knob5"]


def _reference_knob_solve(knob, request):
    """The reference's solve with ``knob`` on ``tiny``: in this process
    where one device suffices (a 2-D mesh of m feature shards is held to
    the reference's m = 1 solve, as in ``test_torch_solver2d``), else
    from the child.  A pod mesh's solve raises in the reference's
    ``_finalize`` on the installed jax (ROADMAP C.9), so its α, w and
    rowmap are fetched to the host first, as the child does.  The
    reference's ``pipeline=False`` driver raises at a scatter on the
    installed jax (ROADMAP C.4), so that knob is held to the reference's
    pipelined solve, which the reference asserts equal to its driver
    (``tests/test_sharded_pipeline.py``)."""
    if knob.get("mesh") is not None and knob["mesh"].shape["data"] > 1:
        return types.SimpleNamespace(
            **request.getfixturevalue("ref_data_shards"))
    kw = {k: v for k, v in knob.items() if k not in ("mesh", "pipeline")}
    if "mesh" in knob:
        kw["mesh"] = jax.make_mesh((1, 1), ("data", "model"))
    if "pod" in knob.get("mesh_axes", ()):
        from test_torch_shards import finalize_on_host
        request.getfixturevalue("monkeypatch").setattr(
            rs, "_finalize", finalize_on_host(rs._finalize))
    return rs.sharded_passcode_solve(make_dataset("tiny").X_train,
                                     rd.Hinge(), **kw, **KNOB_SOLVE)


@pytest.mark.parametrize("knob,item,expect", KNOBS,
                         ids=[f"knob{i}-{c[1]}".replace("′", "'")
                              for i, c in enumerate(KNOBS)])
def test_unported_knobs_raise(tiny, request, knob, item, expect):
    """Each knob of the reference either acts — the ported self-tuning
    and data-shard knobs, whose solve is held to the reference's — or
    raises the reference's own ``ValueError`` (``resolve_self_tuning``,
    ``pipeline_overlap``, the task axis's), with its message.  A (K, n)
    ``y`` is the multi-task solve, held class by class to the
    reference's on the rows it is shaped for."""
    if expect is ValueError:
        with pytest.raises(ValueError) as want:
            rs.sharded_passcode_solve(np.ones((8, 3), np.float32),
                                      rd.Hinge(), epochs=1,
                                      **_reference_knob(knob))
        with pytest.raises(ValueError) as got:
            sharded_passcode_solve(torch.ones((8, 3)), td.Hinge(), epochs=1,
                                   device="cpu", **knob)
        assert str(got.value) == str(want.value)
        return
    if "y" in knob:
        r = rs.sharded_passcode_solve(ONES, rd.Hinge(), **knob, **KNOB_SOLVE)
        Xp = torch.from_numpy(ONES)
        p = sharded_passcode_solve(Xp, td.Hinge(), device="cpu", **knob,
                                   **KNOB_SOLVE)
        _assert_tasks(p, r, Xp, knob["y"], td.Hinge())
        return
    Xp = _port_X(tiny, True)
    p = sharded_passcode_solve(Xp, td.Hinge(), device="cpu", **knob,
                               **KNOB_SOLVE)
    # the host driver records the gap only, as the reference's does
    _assert_result(p, _reference_knob_solve(knob, request), Xp, td.Hinge(),
                   metrics="pipeline" not in knob)


PREPARE_KNOBS = [
    (dict(y=np.ones((2, 8), np.float32)), "A.9", ACTS),
    (dict(mesh_axes=("task", "data")), "A.9", ValueError),
    (dict(mesh_axes=("pod", "data")), "A.10", ACTS),
    (dict(pod_delay_rounds=2), "A.10", ValueError),
    (dict(shrink_every=1, shrink_tol=1e-2), "A.7", ACTS),
    (dict(repack=True, repack_threshold=0.3), "A.7", ValueError),
    (dict(adaptive=True, adaptive_ratio=0.5), "A.7", ACTS),
    (dict(pipeline=False), "A′.12", ACTS),
]


@pytest.mark.parametrize("knob,item,expect", PREPARE_KNOBS,
                         ids=[f"knob{i}-{c[1]}".replace("′", "'")
                              for i, c in enumerate(PREPARE_KNOBS)])
def test_prepare_solver_unported_knobs_raise(knob, item, expect):
    """``prepare_solver`` takes every keyword of the reference's: a
    ported knob resolves as the reference's (``SelfTuning`` and the
    tuning values, ``pipeline=False``'s), and a bad combination raises
    the reference's ``ValueError``.  A (K, n) ``y`` sets the setup's task
    count and labels as the reference's (its padding rows, none here, at
    +1)."""
    X = torch.ones((8, 3))
    if expect is ValueError:
        with pytest.raises(ValueError) as want:
            rs.prepare_solver(np.ones((8, 3), np.float32), rd.Hinge(),
                              **_reference_knob(knob))
        with pytest.raises(ValueError) as got:
            prepare_solver(X, td.Hinge(), device="cpu", **knob)
        assert str(got.value) == str(want.value)
        return
    want = rs.prepare_solver(np.ones((8, 3), np.float32), rd.Hinge(), **knob)
    got = prepare_solver(X, td.Hinge(), device="cpu", **knob)
    assert got.n_tasks == want.n_tasks
    if want.n_tasks:
        np.testing.assert_array_equal(got.Y.numpy(), np.asarray(want.Y))
    assert tuple(got.tuning) == tuple(want.tuning)
    assert (got.shrink_tol, got.repack_threshold, got.adaptive_ratio) == (
        want.shrink_tol, want.repack_threshold, want.adaptive_ratio)


@pytest.mark.parametrize("knob", [dict(shrink_tol=1e-3),
                                  dict(shrink_tol=0.25),
                                  dict(repack_threshold=0.1),
                                  dict(adaptive_ratio=0.5),
                                  dict(mesh_axes=("data",), pipeline=True,
                                       shrink_every=0, repack="auto",
                                       adaptive=False)],
                         ids=["shrink_tol", "shrink_tol_other",
                              "repack_threshold", "adaptive_ratio",
                              "defaults"])
def test_reference_keywords_that_do_not_act_are_accepted(tiny, knob):
    """The reference's call ``sharded_passcode_solve(X, Hinge(C=1),
    shrink_tol=1e-3)`` and its siblings run, and give the same solve as
    the call without the knob (ROADMAP C.1); ``prepare_solver`` takes
    them too."""
    Xp = _port_X(tiny, True)
    kw = dict(epochs=2, block_size=32, seed=1, device="cpu")
    base = sharded_passcode_solve(Xp, td.Hinge(C=1), **kw)
    got = sharded_passcode_solve(Xp, td.Hinge(C=1), **kw, **knob)
    for a, b in zip(got[:3], base[:3]):
        assert torch.equal(a, b)
    setup = prepare_solver(Xp, td.Hinge(C=1), device="cpu", **knob)
    assert setup.n == Xp.n_rows
