"""The per-epoch host driver (``pipeline=False``) and its epoch builders.

The port's ``sharded_passcode_solve(..., pipeline=False)`` runs
``_drive_epochs`` over ``make_sharded_epoch`` (1-D: ELL and dense) or
``make_sharded_epoch_2d`` (2-D: unfused, fused, and overlapped at
delay 1).  It is held to two things on ``tiny``:

* the port's own pipelined solve at the same seed — rtol/atol 1e-5 on
  α and ŵ and 1e-3 on the gaps, the tolerances the reference holds its
  driver to its pipelined solve with (``tests/test_sharded_pipeline.py``);
* the reference's pipelined solve on one device — atol 1e-5 on α and ŵ
  and the gap at 1e-5 + 1e-6·M (ROADMAP C.2, ``test_torch_solver.
  _gap_atol``).  The reference's own driver raises at a scatter on the
  installed jax (ROADMAP C.4), so it is not run; the reference asserts it
  equal to its pipelined solve.

Also: the driver's draw (``_masked_block_perms``) against the
reference's bit for bit, the builders' signatures against the
reference's, the p > 1 shard grid and an explicit schedule, and the
knobs the driver refuses with the reference's ``ValueError``.
"""

import functools
import inspect

import jax
import numpy as np
import pytest
import torch

from repro.core import duals as rd
from repro.core import sharded as rs
from repro.data import make_dataset
from repro_torch import prng
from repro_torch.convert import dense_from_numpy, ell_from_numpy
from repro_torch.core import duals as td
from repro_torch.core import sharded as ts
from repro_torch.dist.mesh import solver_mesh, solver_mesh_2d

from test_torch_solver import ATOL, _gap_atol

EPOCHS, B, SEED = 2, 32, 3
LOSSES = ("hinge", "squared_hinge", "logistic")


@functools.lru_cache(maxsize=None)
def _port_X(layout):
    X = make_dataset("tiny").X_train
    if layout == "dense":
        return dense_from_numpy(np.asarray(X.to_dense()), device="cpu")
    return ell_from_numpy(np.asarray(X.indices), np.asarray(X.values),
                          X.n_features, device="cpu")


def _mesh_kw(layout, fused=False):
    if layout == "2d":
        return dict(mesh=solver_mesh_2d(model=2), use_kernel=fused)
    return {}


@functools.lru_cache(maxsize=None)
def _ref_pipelined(layout, loss, delay_rounds, fused=False):
    X = make_dataset("tiny").X_train
    if layout == "dense":
        X = X.to_dense()
    kw = dict(epochs=EPOCHS, block_size=B, delay_rounds=delay_rounds,
              seed=SEED)
    if layout == "2d":
        kw.update(mesh=jax.make_mesh((1, 1), ("data", "model")),
                  use_kernel=fused)
    return rs.sharded_passcode_solve(X, rd.make_loss(loss), **kw)


# (layout, loss, delay_rounds, fused)
CASES = [(lay, loss, dr, False) for lay in ("ell", "dense", "2d")
         for loss in LOSSES for dr in (0, 1)] + [
    ("2d", "hinge", 0, True), ("2d", "logistic", 1, True)]


@pytest.mark.parametrize(
    "layout,loss,delay_rounds,fused", CASES,
    ids=[f"{c[0]}-{c[1]}-d{c[2]}{'-fused' if c[3] else ''}" for c in CASES])
def test_driver_matches_pipelined(layout, loss, delay_rounds, fused):
    Xp, lp = _port_X("dense" if layout == "dense" else "ell"), \
        td.make_loss(loss)
    kw = dict(epochs=EPOCHS, block_size=B, delay_rounds=delay_rounds,
              seed=SEED, device="cpu", **_mesh_kw(layout, fused))
    drv = ts.sharded_passcode_solve(Xp, lp, pipeline=False, **kw)
    pipe = ts.sharded_passcode_solve(Xp, lp, **kw)
    for a, b in ((drv.alpha, pipe.alpha), (drv.w_hat, pipe.w_hat)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(drv.gaps.numpy(), pipe.gaps.numpy(),
                               rtol=1e-3, atol=1e-3)
    assert drv.eps is None and drv.rounds == EPOCHS
    ref = _ref_pipelined(layout, loss, delay_rounds, fused)
    np.testing.assert_allclose(drv.alpha.numpy(), np.asarray(ref.alpha),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(drv.w_hat.numpy(), np.asarray(ref.w_hat),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(drv.gaps.numpy(), np.asarray(ref.gaps),
                               rtol=0, atol=_gap_atol(Xp, drv.alpha, lp))


@pytest.mark.parametrize("loss", ["hinge", "logistic"])
def test_driver_overlap_matches_pipelined_overlap(loss):
    """The overlapped 2-D round at delay 1 under the driver: the (base,
    Gram) of each epoch's first block formed against the entering w each
    dispatch, where the pipelined solve carries it across epochs — the
    same update sequence, held to the port's pipelined overlap, the
    reference's pipelined overlap and the unfused round."""
    Xp, lp = _port_X("ell"), td.make_loss(loss)
    kw = dict(epochs=EPOCHS, block_size=B, delay_rounds=1, seed=SEED,
              device="cpu", mesh=solver_mesh_2d(model=2), use_kernel=True,
              overlap=True)
    drv = ts.sharded_passcode_solve(Xp, lp, pipeline=False, **kw)
    pipe = ts.sharded_passcode_solve(Xp, lp, **kw)
    unfused = ts.sharded_passcode_solve(
        Xp, lp, pipeline=False, **dict(kw, use_kernel=False, overlap=False))
    for other in (pipe, unfused):
        np.testing.assert_allclose(drv.alpha.numpy(), other.alpha.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(drv.w_hat.numpy(), other.w_hat.numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(drv.gaps.numpy(), pipe.gaps.numpy(),
                               rtol=1e-3, atol=1e-3)
    ref = _ref_pipelined("2d", loss, 1, True)
    np.testing.assert_allclose(drv.alpha.numpy(), np.asarray(ref.alpha),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(drv.w_hat.numpy(), np.asarray(ref.w_hat),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("p,n_loc,n", [(1, 256, 256), (4, 64, 256),
                                       (3, 86, 256), (8, 40, 300)])
def test_masked_block_perms_match_reference(p, n_loc, n):
    nb = rs._n_blocks(n_loc, 16)
    sub = jax.random.split(jax.random.PRNGKey(7))[1]
    want = np.asarray(rs._masked_block_perms(sub, p, n_loc, n, nb, 16))
    got = ts._masked_block_perms(prng.split(prng.PRNGKey(7))[1], p, n_loc,
                                 n, nb, 16)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["make_sharded_epoch",
                                  "make_sharded_epoch_2d"])
def test_epoch_builders_take_the_reference_arguments(name):
    """The reference's keywords, in its order (``device`` added last);
    ``interpret`` only at its default."""
    ref = inspect.signature(getattr(rs, name)).parameters
    got = inspect.signature(getattr(ts, name)).parameters
    assert list(got)[:len(ref)] == list(ref) and list(got)[-1] == "device"
    mesh = (solver_mesh() if name == "make_sharded_epoch"
            else solver_mesh_2d())
    with pytest.raises(ValueError, match="interpret"):
        getattr(ts, name)(mesh, td.Hinge(), interpret=True, device="cpu")


@pytest.mark.parametrize("layout,p,delay_rounds", [
    ("ell", 4, 1), ("dense", 3, 0), ("2d", 2, 1)])
def test_driver_on_data_shards_matches_pipelined(layout, p, delay_rounds):
    Xp = _port_X("dense" if layout == "dense" else "ell")
    mesh = (solver_mesh_2d(data=p, model=2) if layout == "2d"
            else solver_mesh(n_devices=p))
    kw = dict(epochs=EPOCHS, block_size=16, delay_rounds=delay_rounds,
              seed=SEED, device="cpu", mesh=mesh, gap_every=2)
    drv = ts.sharded_passcode_solve(Xp, td.Hinge(), pipeline=False, **kw)
    pipe = ts.sharded_passcode_solve(Xp, td.Hinge(), **kw)
    np.testing.assert_allclose(drv.alpha.numpy(), pipe.alpha.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(drv.w_hat.numpy(), pipe.w_hat.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert drv.gaps.shape == pipe.gaps.shape == (1,)
    np.testing.assert_allclose(drv.gaps.numpy(), pipe.gaps.numpy(),
                               rtol=1e-3, atol=1e-3)


def test_driver_explicit_schedule_and_epoch_fn():
    """``blocks=`` replaces the driver's draw as it does the pipelined
    one's; ``make_sharded_epoch`` called by hand on the solver's layout
    runs one epoch of the same rounds."""
    Xp = _port_X("ell")
    kw = dict(epochs=1, block_size=B, seed=SEED, device="cpu",
              record=False)
    seeded = ts.sharded_passcode_solve(Xp, td.Hinge(), pipeline=False, **kw)
    setup = ts.prepare_solver(Xp, td.Hinge(), block_size=B, seed=SEED,
                              device="cpu")
    sub = prng.split(prng.PRNGKey(SEED))[1]
    blocks = ts._masked_block_perms(sub, 1, setup.n_loc, setup.n,
                                    setup.n_blocks, B)
    sched = ts.sharded_passcode_solve(
        Xp, td.Hinge(), pipeline=False,
        blocks=blocks.reshape(1, setup.n_blocks, B), **kw)
    fn = ts.make_sharded_epoch(solver_mesh(), td.Hinge(), ell=True,
                               device="cpu")
    alpha, w, dw = fn(setup.X, setup.sq_norms,
                      torch.zeros(setup.n_pad), torch.zeros(setup.w_shape),
                      blocks.reshape(setup.n_blocks, B),
                      torch.zeros(setup.w_shape))
    for r in (sched,):
        assert torch.equal(r.alpha, seeded.alpha)
        assert torch.equal(r.w_hat, seeded.w_hat)
    assert torch.equal(alpha[:setup.n], seeded.alpha)
    assert torch.equal(w[:setup.d], seeded.w_hat) and not dw.any()


@pytest.mark.parametrize("knob", [
    dict(y=np.ones((2, 256), np.float32)),
    dict(mesh_axes=("pod", "data")),
    dict(shrink_every=1),
    dict(adaptive=True)], ids=["multitask", "pods", "shrink", "adaptive"])
def test_driver_refuses_what_the_reference_refuses(knob):
    X = make_dataset("tiny").X_train
    with pytest.raises(ValueError) as want:
        rs.sharded_passcode_solve(X, rd.Hinge(), epochs=1, pipeline=False,
                                  **knob)
    with pytest.raises(ValueError) as got:
        ts.sharded_passcode_solve(_port_X("ell"), td.Hinge(), epochs=1,
                                  pipeline=False, device="cpu", **knob)
    # the same message, naming the port's module where it names one
    assert str(got.value) == str(want.value).replace("repro.", "repro_torch.")
