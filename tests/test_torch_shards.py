"""The 1-D solve over p > 1 ``data`` shards against the reference's on p
fake CPU devices.

The reference runs in one child process per module
(``reference_solves``, below, which ``test_torch_shards2d``,
``test_torch_selftuning`` and ``test_torch_solver`` also use:
``tests/conftest.py`` pins one device here); the port runs its shards' plain versions on the CPU, with
the same seed, so the same key chain draws the same blocks.  Cases:
dense and ELL at p ∈ {2, 4, 8} and B = 8, each with delay_rounds 0 and 1
and the three losses spread over them; p ∤ n (n = 250 at p = 4); a
shard that owns only padding (n = 20 at p = 8); and an explicit
(epochs, p, n_blocks, B) schedule.  The plain versions with a shard grid
are held to p single-shard calls summed in shard order.

Tolerances: α and ŵ at atol 1e-5; the gap and ‖w(α) − ŵ‖ at
1e-5 + 1e-6·M (``test_torch_solver._gap_atol``); the delay records
equal.

``reference_solves`` runs the reference's p > 1 solves in one child
process with ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and
reads back its results (α, ŵ and the per-record gaps, ‖w(α) − ŵ‖,
active fractions and delay flags) as numpy arrays.  A ``case`` is plain
data: ``rows`` (the first rows of ``tiny``), ``dense`` (the rows as a
dense matrix instead of ELL), ``loss`` (its name, C = 1), ``p`` (data
shards), ``model`` (feature shards of a 2-D mesh, or None for the 1-D
mesh), ``Y`` and ``task`` (a multi-task solve's label matrix and the
size of its 'task' mesh axis, or None) and ``kw`` (the other keywords
of ``sharded_passcode_solve``).
On the installed jax, the reference's ``_finalize`` slices α[:n] of a
row-sharded α, which raises ``ShardingTypeError`` when p ∤ n, and on a
pod mesh scatters the row-sharded α through the rowmap ``setup.ridx``,
which raises it at every mesh (ROADMAP C.9); the child wraps
``_finalize`` to fetch α, w and ``ridx`` to the host first
(``finalize_on_host``).  Nothing of ``repro`` changes.  A ``case``'s
``pods`` (P) and ``kw["pod_delay_rounds"]`` run it on a pod mesh: (pod =
P, data = p) for the 1-D mesh, ``solver_mesh_3d(pod=P, data=p,
model=m)`` for the 2-D one.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import sharded as rs
from repro.data import make_dataset
from repro_torch import prng
from repro_torch.convert import dense_from_numpy, ell_from_numpy
from repro_torch.core import duals as td
from repro_torch.core import sharded as ts
from repro_torch.dist.mesh import solver_mesh
from repro_torch.kernels import dcd_block, dcd_ell

from test_torch_solver import ATOL, _gap_atol

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, os, sys
import jax
import numpy as np
from repro.core import duals as rd
from repro.core import sharded as rs
from repro.data import make_dataset
from repro.data.sparse import EllMatrix
from repro.dist.mesh import (solver_mesh, solver_mesh_2d, solver_mesh_3d,
                             solver_mesh_tasks)

_finalize = rs._finalize


def _finalize_on_host(setup, alpha, w, *args, **kw):
    if setup.ridx is not None:
        setup = setup._replace(ridx=np.asarray(jax.device_get(setup.ridx)))
    return _finalize(setup, jax.device_get(alpha), jax.device_get(w),
                     *args, **kw)


rs._finalize = _finalize_on_host
cases = json.loads(open(sys.argv[1]).read())
X = make_dataset("tiny").X_train
for name, c in cases.items():
    r = c["rows"]
    Xc = EllMatrix(X.indices[:r], X.values[:r], X.n_features)
    if c["dense"]:
        Xc = np.asarray(Xc.to_dense())
    mesh = (solver_mesh(n_devices=c["p"]) if c["model"] is None
            else solver_mesh_2d(data=c["p"], model=c["model"]))
    P = c.get("pods")
    if P and c["model"] is None:
        mesh = jax.make_mesh((P, c["p"]), ("pod", "data"),
                             devices=jax.devices()[:P * c["p"]])
    elif P:
        mesh = solver_mesh_3d(pod=P, data=c["p"], model=c["model"],
                              n_devices=P * c["p"] * c["model"])
    if c.get("task"):
        mesh = solver_mesh_tasks(task=c["task"], data=c["p"],
                                 model=c["model"] or 1)
    Y = c.get("Y")
    res = rs.sharded_passcode_solve(
        Xc, rd.make_loss(c["loss"]), mesh=mesh,
        y=None if Y is None else np.asarray(Y, np.float32), **c["kw"])
    np.savez(os.path.join(sys.argv[2], name + ".npz"),
             **{k: np.asarray(getattr(res, k))
                for k in ("alpha", "w_hat", "gaps", "eps", "active",
                          "delay")})
"""


def case(rows=256, dense=False, loss="hinge", p=2, model=None, Y=None,
         task=None, pods=None, **kw):
    """A reference solve for ``reference_solves``; ``Y`` a (K, rows) ±1
    label matrix (nested lists) makes it a multi-task solve, ``task`` the
    size of a leading 'task' mesh axis, ``pods`` the size of a leading
    'pod' axis (with ``pod_delay_rounds`` among ``kw``)."""
    return dict(rows=rows, dense=dense, loss=loss, p=p, model=model, kw=kw,
                Y=Y, task=task, pods=pods)


def finalize_on_host(finalize):
    """The reference's ``_finalize`` with α, w and the pod rowmap
    ``setup.ridx`` fetched to the host first (the child's wrapper, for a
    solve in this process)."""

    def on_host(setup, alpha, w, *args, **kw):
        if setup.ridx is not None:
            setup = setup._replace(
                ridx=np.asarray(jax.device_get(setup.ridx)))
        return finalize(setup, jax.device_get(alpha), jax.device_get(w),
                        *args, **kw)

    return on_host


def reference_solves(cases: dict, out_dir) -> dict:
    """Run every case of ``cases`` (name → ``case(...)``) through the
    reference on 8 fake CPU devices, in one child; returns name → dict of
    arrays."""
    out_dir = Path(out_dir)
    spec = out_dir / "cases.json"
    spec.write_text(json.dumps(cases))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-c", CHILD, str(spec),
                           str(out_dir)], env=env, capture_output=True,
                          text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"the reference's child failed:\n{done.stderr}")
    return {name: dict(np.load(out_dir / f"{name}.npz")) for name in cases}


EPOCHS, B, SEED = 3, 8, 11
LOSSES = ("hinge", "squared_hinge", "logistic")

CASES = {}
for _ki, _dense in enumerate((False, True)):
    for _pi, _p in enumerate((2, 4, 8)):
        for _dr in (0, 1):
            _loss = LOSSES[(_ki + _pi + _dr) % 3]
            CASES[f"{'dense' if _dense else 'ell'}-p{_p}-{_loss}-d{_dr}"] = \
                case(dense=_dense, loss=_loss, p=_p, epochs=EPOCHS,
                     block_size=B, delay_rounds=_dr, seed=SEED)
CASES.update({
    "ell-n250-p4": case(rows=250, p=4, epochs=EPOCHS, block_size=B,
                        seed=SEED),
    "dense-n250-p4-logistic": case(rows=250, dense=True, loss="logistic",
                                   p=4, epochs=EPOCHS, block_size=B,
                                   delay_rounds=1, seed=SEED),
    "ell-n20-p8": case(rows=20, p=8, epochs=EPOCHS, block_size=2,
                       seed=SEED),
    "dense-n20-p8-squared_hinge": case(rows=20, dense=True,
                                       loss="squared_hinge", p=8,
                                       epochs=EPOCHS, block_size=2,
                                       seed=SEED),
})


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_solves(CASES, tmp_path_factory.mktemp("ref_shards"))


@pytest.fixture(scope="module")
def tiny():
    X = make_dataset("tiny").X_train
    return (np.array(X.indices), np.array(X.values), X.n_features,
            np.array(X.to_dense()))


def port_X(tiny, rows, dense):
    idx, val, d, dense_X = tiny
    if dense:
        return dense_from_numpy(dense_X[:rows], device="cpu")
    return ell_from_numpy(idx[:rows], val[:rows], d, device="cpu")


def assert_matches(p, r, Xp, loss):
    np.testing.assert_allclose(p.alpha.numpy(), r["alpha"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(p.w_hat.numpy(), r["w_hat"], rtol=0,
                               atol=ATOL)
    tol = _gap_atol(Xp, p.alpha, loss)
    np.testing.assert_allclose(p.gaps.numpy(), r["gaps"], rtol=0, atol=tol)
    np.testing.assert_allclose(p.eps.numpy(), r["eps"], rtol=0, atol=tol)
    np.testing.assert_array_equal(p.active.numpy(), r["active"])
    np.testing.assert_array_equal(p.delay.numpy(), r["delay"])


def solve(tiny, c, **extra):
    Xp = port_X(tiny, c["rows"], c["dense"])
    loss = td.make_loss(c["loss"])
    res = ts.sharded_passcode_solve(Xp, loss, mesh=solver_mesh(
        n_devices=c["p"]), device="cpu", **c["kw"], **extra)
    return res, Xp, loss


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_1d_matches_reference(ref, tiny, name):
    c = CASES[name]
    res, Xp, loss = solve(tiny, c)
    assert res.alpha.shape == (c["rows"],)
    assert np.isfinite(res.gaps.numpy()).all()
    assert_matches(res, ref[name], Xp, loss)


def test_explicit_shard_schedule_is_the_seeded_draw(ref, tiny):
    """``blocks=`` at p > 1 takes an (epochs, p, n_blocks, B) schedule of
    shard-local ids: the reference's own draw gives the seeded solve."""
    name = "ell-p4-squared_hinge-d0"
    c = CASES[name]
    n_loc, p = 64, 4
    nb = rs._n_blocks(n_loc, B)
    key, sched = jax.random.PRNGKey(SEED), []
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        sched.append(np.stack([np.asarray(rs._device_block_perm(
            sub, my, p, n_loc, 256, nb, B)) for my in range(p)]))
    res, Xp, loss = solve(tiny, c, blocks=np.stack(sched))
    seeded, _, _ = solve(tiny, c)
    np.testing.assert_array_equal(res.alpha.numpy(), seeded.alpha.numpy())
    np.testing.assert_array_equal(res.w_hat.numpy(), seeded.w_hat.numpy())
    assert_matches(res, ref[name], Xp, loss)


@pytest.mark.parametrize("bad", ["shape", "range", "p1_shape"])
def test_explicit_shard_schedule_is_checked(tiny, bad):
    c = CASES["ell-p4-squared_hinge-d0"]
    nb = rs._n_blocks(64, B)
    sched = {"shape": np.zeros((EPOCHS, nb, B)),
             "range": np.full((EPOCHS, 4, nb, B), 64),
             "p1_shape": np.zeros((EPOCHS, 1, nb, B))}[bad]
    kw = dict(c["kw"])
    if bad == "p1_shape":
        kw.update(block_size=32)
        sched = np.zeros((EPOCHS, 1, 8, 32))
        with pytest.raises(ValueError, match="blocks"):
            ts.sharded_passcode_solve(port_X(tiny, 256, False), td.Hinge(),
                                      device="cpu", blocks=sched, **kw)
        return
    with pytest.raises(ValueError, match="blocks"):
        solve(tiny, c, blocks=sched)


def test_padding_rows_and_layout(tiny):
    """n = 250 at p = 4: n_loc = 63, two padding rows at the tail with
    q = 1 and no entries, never moved; the padding-only shard of n = 20
    at p = 8 draws its local row 0 only."""
    Xp = port_X(tiny, 250, False)
    s = ts.prepare_solver(Xp, td.Hinge(), mesh=solver_mesh(n_devices=4),
                          block_size=B, device="cpu")
    assert (s.p, s.n_loc, s.n_pad, s.n_blocks) == (4, 63, 252, 8)
    cols, vals = s.X
    assert cols.shape == (252, Xp.k_max)
    assert (cols[250:] == Xp.n_features).all() and (vals[250:] == 0).all()
    assert (s.sq_norms[250:] == 1.0).all()
    sub = prng.split(prng.PRNGKey(0))[1]
    last = ts._device_block_perm(sub, 7, 8, 3, 20, 2, 2)
    assert (last == 0).all()
    for my, v in [(0, 3), (6, 2)]:
        got = ts._device_block_perm(sub, my, 8, 3, 20, 2, 2)
        assert set(got.reshape(-1).tolist()) <= set(range(v))


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("per_shard_w", [False, True])
def test_shard_grid_plain_is_p_single_calls(tiny, dense, per_shard_w):
    """B1's and B2's plain versions over a shard grid equal p
    single-shard calls, each against its w, summed in shard order."""
    p, n_loc, Bk = 4, 64, 16
    idx_np, val, d, dense_X = tiny
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, n_loc, (p, Bk)).astype(np.int32))
    alpha = torch.from_numpy(rng.uniform(0, 0.5, 256).astype(np.float32))
    act = torch.from_numpy((rng.uniform(size=256) > 0.2).astype(np.float32))
    width = d if dense else d + 1
    w = torch.from_numpy((rng.standard_normal((p, width) if per_shard_w
                                              else (width,)) * 0.05)
                         .astype(np.float32))
    if not dense:
        w[..., d] = 0.0
    loss = td.SquaredHinge()
    if dense:
        X = torch.from_numpy(dense_X)
        q = (X * X).sum(1)
        got_a, got_dw = dcd_block.dcd_indexed_shards(
            X, alpha, w, q, loss=loss, idx=ids, n_loc=n_loc, active=act)
    else:
        cols, vals = torch.from_numpy(idx_np), torch.from_numpy(val)
        q = (vals * vals).sum(1)
        got_a, got_dw = dcd_ell.dcd_ell_shards(
            cols, vals, alpha, w, q, loss=loss, idx=ids, n_loc=n_loc,
            active=act)
    a, total = alpha, torch.zeros(width)
    for s in range(p):
        w_s = w[s] if per_shard_w else w
        gid = ids[s] + s * n_loc
        if dense:
            a, w_new = dcd_block.dcd_indexed_epoch(X, a, w_s, q, loss=loss,
                                                   idx=gid, active=act)
        else:
            a, w_new = dcd_ell.dcd_ell_epoch(cols, vals, a, w_s, q,
                                             loss=loss, idx=gid, active=act)
        assert torch.equal(got_dw[s], w_new - w_s)
        total = total + (w_new - w_s)
    assert torch.equal(got_a, a)
    torch.testing.assert_close(ts._shard_sum(got_dw[None])[0], total,
                               rtol=0, atol=1e-6)
