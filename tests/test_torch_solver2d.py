"""The port's 2-D (feature-sharded) solve against the reference's.

At m = 1 the port's ``sharded_passcode_solve(mesh=solver_mesh_2d())``
is held to the reference's on ``jax.make_mesh((1, 1), ("data",
"model"))`` with the same seed: unfused (``use_kernel=False`` on both)
and fused (``use_kernel=True``; the reference's Pallas kernels in
interpret mode, the port's plain B4/B5), delay_rounds 0 and 1 (with 1,
``overlap="auto"`` turns the overlapped round on in both).  At m = 2
and 4 the port is held to the reference's m = 1 solve: splitting the
features changes only the order of float32 sums.

Tolerances: α and ŵ at atol 1e-5; the gap and ‖w(α) − ŵ‖ at
1e-5 + 1e-6·M (``test_torch_solver._gap_atol``: both are float32 sums
over rows or features taken in another order).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import duals as rd
from repro.core import sharded as rs
from repro.data import make_dataset
from repro_torch.convert import (
    dense_from_numpy,
    ell_from_numpy,
    state_from_numpy,
    w2d_to_numpy,
)
from repro_torch.core import duals as td
from repro_torch.core import sharded as ts
from repro_torch.dist.mesh import solver_mesh_2d

from test_torch_solver import ATOL, _gap_atol

EPOCHS, B, SEED = 3, 32, 5


@pytest.fixture(scope="module")
def tiny():
    X = make_dataset("tiny").X_train
    Xp = ell_from_numpy(np.asarray(X.indices), np.asarray(X.values),
                        X.n_features, device="cpu")
    return X, Xp


@functools.lru_cache(maxsize=None)
def _ref_solve(loss, use_kernel, delay_rounds):
    X = make_dataset("tiny").X_train
    return rs.sharded_passcode_solve(
        X, rd.make_loss(loss), mesh=jax.make_mesh((1, 1), ("data", "model")),
        use_kernel=use_kernel, epochs=EPOCHS, block_size=B,
        delay_rounds=delay_rounds, seed=SEED)


def _assert_matches(p, r, Xp, loss):
    np.testing.assert_allclose(p.alpha.numpy(), np.asarray(r.alpha), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(p.w_hat.numpy(), np.asarray(r.w_hat), rtol=0,
                               atol=ATOL)
    tol = _gap_atol(Xp, p.alpha, loss)
    np.testing.assert_allclose(p.gaps.numpy(), np.asarray(r.gaps), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(p.eps.numpy(), np.asarray(r.eps), rtol=0,
                               atol=tol)
    np.testing.assert_array_equal(p.delay.numpy(), np.asarray(r.delay))
    assert p.rounds == r.rounds


# (m, loss, use_kernel, delay_rounds); the reference solves at m = 1
CASES = [(1, loss, uk, dr) for loss in ("hinge", "squared_hinge", "logistic")
         for uk in (False, True) for dr in (0, 1)] + [
    (m, loss, uk, dr) for m in (2, 4) for loss in ("hinge", "logistic")
    for uk, dr in ((False, 0), (True, 1))]


@pytest.mark.parametrize(
    "m,loss,use_kernel,delay_rounds", CASES,
    ids=[f"m{c[0]}-{c[1]}-k{int(c[2])}-d{c[3]}" for c in CASES])
def test_2d_solve_matches_reference(tiny, m, loss, use_kernel,
                                    delay_rounds):
    _, Xp = tiny
    r = _ref_solve(loss, use_kernel, delay_rounds)
    lf = td.make_loss(loss)
    p = ts.sharded_passcode_solve(
        Xp, lf, mesh=solver_mesh_2d(model=m), use_kernel=use_kernel,
        epochs=EPOCHS, block_size=B, delay_rounds=delay_rounds, seed=SEED,
        device="cpu")
    _assert_matches(p, r, Xp, lf)


def test_engine_resolution_on_cpu(tiny):
    """"auto" keeps the unfused engine on the CPU; True fuses, and with
    delay_rounds ≥ 1 overlaps; the 1-D mesh never overlaps."""
    _, Xp = tiny
    two = solver_mesh_2d(model=2)
    for kw, fused, overlap in [
            (dict(use_kernel="auto", delay_rounds=1), False, False),
            (dict(use_kernel=True, delay_rounds=0), True, False),
            (dict(use_kernel=True, delay_rounds=1), True, True),
            (dict(use_kernel=True, delay_rounds=1, overlap=False), True,
             False)]:
        s = ts.prepare_solver(Xp, td.Hinge(), mesh=two, device="cpu", **kw)
        assert (s.two_d, s.m, s.fused, s.overlap) == (True, 2, fused,
                                                      overlap)
        assert s.w_shape == (2, s.d_loc + 1)
    s = ts.prepare_solver(Xp, td.Hinge(), use_kernel=True, delay_rounds=1,
                          device="cpu")
    assert not (s.two_d or s.fused or s.overlap)
    with pytest.raises(ValueError, match="fused"):
        ts.prepare_solver(Xp, td.Hinge(), mesh=two, use_kernel=False,
                          delay_rounds=1, overlap=True, device="cpu")
    # mesh_axes alone means m = 1, a legacy ("model",) mesh data = 1
    assert ts._resolve_mesh(None, ("data", "model")).shape == {
        "data": 1, "model": 1}
    legacy = ts.SolverMesh(("model",), (3,))
    assert ts._resolve_mesh(legacy, ("data",)).shape == {"data": 1,
                                                         "model": 3}


def test_2d_warm_start_and_layout_match_reference(tiny):
    """A warm start from the reference's (α0, w0); the re-blocked primal
    is the reference's 2-D layout (``_init_alpha_w``), carried by the
    converter."""
    X, Xp = tiny
    rng = np.random.default_rng(0)
    a0 = rng.uniform(0, 0.5, 200).astype(np.float32)  # shorter than n
    w0 = (rng.standard_normal(128) * 0.05).astype(np.float32)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref_setup = rs.prepare_solver(X, rd.Hinge(), mesh=mesh, use_kernel=True)
    _, ref_w = rs._init_alpha_w(ref_setup, a0, w0)
    kw = dict(epochs=2, block_size=64, seed=2)
    r = rs.sharded_passcode_solve(X, rd.Hinge(), mesh=mesh, alpha0=a0,
                                  w0=w0, **kw)
    pa0, pw0 = state_from_numpy(a0, w0, device="cpu")
    setup = ts.prepare_solver(Xp, td.Hinge(), mesh=solver_mesh_2d(),
                              device="cpu")
    _, w = ts._init_alpha_w(setup, pa0, pw0)
    np.testing.assert_array_equal(w2d_to_numpy(w, ref_setup.d1_loc),
                                  np.asarray(ref_w))
    p = ts.sharded_passcode_solve(Xp, td.Hinge(), mesh=solver_mesh_2d(),
                                  alpha0=pa0, w0=pw0, device="cpu", **kw)
    _assert_matches(p, r, Xp, td.Hinge())


def test_2d_dense_input_and_record_off(tiny):
    """A dense X converts to ELL on the 2-D mesh; record=False records
    nothing and runs the same updates."""
    X, Xp = tiny
    dense = np.asarray(X.to_dense())
    kw = dict(epochs=2, block_size=B, seed=SEED, delay_rounds=1)
    r = rs.sharded_passcode_solve(
        dense, rd.Logistic(), mesh=jax.make_mesh((1, 1), ("data", "model")),
        **kw)
    mesh = solver_mesh_2d(model=2)
    Xd = dense_from_numpy(dense, device="cpu")
    p = ts.sharded_passcode_solve(Xd, td.Logistic(), mesh=mesh, device="cpu",
                                  **kw)
    _assert_matches(p, r, Xp, td.Logistic())
    off = ts.sharded_passcode_solve(Xd, td.Logistic(), mesh=mesh,
                                    record=False, device="cpu", **kw)
    assert off.gaps.shape == (0,) and off.eps.shape == (0,)
    np.testing.assert_array_equal(off.alpha.numpy(), p.alpha.numpy())


def test_2d_explicit_blocks_and_shim(tiny):
    """An explicit schedule replaces the draw (the overlapped round's
    peek past the last epoch included); the n-row-block shim raises."""
    X, Xp = tiny
    key, blocks = jax.random.PRNGKey(SEED), []
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        blocks.append(np.asarray(rs._masked_block_perms(
            sub, 1, 256, 256, 8, B)).reshape(8, B))
    kw = dict(mesh=solver_mesh_2d(model=2), use_kernel=True, delay_rounds=1,
              epochs=EPOCHS, block_size=B, device="cpu")
    seeded = ts.sharded_passcode_solve(Xp, td.Hinge(), seed=SEED, **kw)
    sched = ts.sharded_passcode_solve(Xp, td.Hinge(), blocks=np.stack(blocks),
                                      **kw)
    np.testing.assert_array_equal(sched.alpha.numpy(), seeded.alpha.numpy())
    np.testing.assert_array_equal(sched.w_hat.numpy(), seeded.w_hat.numpy())
    with pytest.raises(NotImplementedError, match="A′.12"):
        ts.sharded_passcode_feature(Xp, td.Hinge())


def test_2d_gap_in_row_chunks_matches_one_pass(tiny):
    """The 2-D gap works in row chunks (no (n, m, k_loc) temporary at
    webspam's size); chunks of a few rows give the one-pass values."""
    _, Xp = tiny
    setup = ts.prepare_solver(Xp, td.Logistic(), mesh=solver_mesh_2d(model=3),
                              device="cpu")
    rng = np.random.default_rng(1)
    alpha = torch.from_numpy(rng.uniform(0.1, 0.9, 256).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal(setup.w_shape) * 0.1).astype(
        np.float32))
    w[:, -1] = 0.0
    whole = ts._make_gap_2d(td.Logistic(), *setup.X)(alpha, w)
    chunked = ts._make_gap_2d(td.Logistic(), *setup.X, chunk_elems=200)(
        alpha, w)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("epochs", [1, 3])
def test_overlapped_round_hands_b5_its_own_blocks_workspace(epochs):
    """In the overlapped round B4 of block t + 1 runs before B5 of block
    t; with two workspaces that alternate, the one B5 of each block is
    handed still holds that block's buckets.  Recording stand-ins for
    the phases track which block each workspace was last filled with;
    with one workspace for both (the single-buffered round), B5 would
    read the next block's."""
    n_blocks = 4
    sched = [torch.arange(e * n_blocks, (e + 1) * n_blocks,
                          dtype=torch.int32).reshape(n_blocks, 1)
             for e in range(epochs + 1)]

    def run(workspaces):
        filled, seen = {}, []

        def gram_fn(w_ref, idx, workspace):
            filled[id(workspace)] = int(idx[0])
            return torch.zeros(1), torch.zeros(1, 1)

        def corr_fn(dvec, idx):
            return torch.zeros(1)

        def update_fn(alpha, w_ref, idx, base, gram, workspace):
            seen.append((int(idx[0]), filled[id(workspace)]))
            return alpha, w_ref

        alpha, w = torch.zeros(1), torch.zeros(1)
        inflight = (*gram_fn(w, sched[0][0], workspaces[0]), workspaces[0])
        for e in range(epochs):
            alpha, w, dw, inflight = ts._scan_rounds_overlap(
                gram_fn, corr_fn, update_fn, alpha, w, torch.zeros(1),
                sched[e], inflight, sched[e + 1][0], workspaces)
        return seen

    seen = run((object(), object()))
    assert [b for b, _ in seen] == list(range(epochs * n_blocks))
    assert all(block == held for block, held in seen)
    one = object()
    assert not any(block == held for block, held in run((one, one)))
