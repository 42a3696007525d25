"""``repro_torch.core.passcode`` against ``repro.core.passcode`` on the
same data and seeds (CPU).

Inputs are the reference's ``tiny`` recipe (ELL, and the same rows
dense) and ``tiny-dense``, carried across with ``repro_torch.convert``.
Both packages draw from the same key chain, so a seed gives the same
rounds, schedule positions and conflict draws (held exactly below).

Tolerances: atol 1e-5 on α, ŵ, w̄ and ‖w̄ − ŵ‖; the gap at
1e-5 + 1e-6·M as in ``test_torch_solver.py`` (ROADMAP C.2).

Lock and Atomic are continuous in their inputs and are held over whole
5-epoch solves.  Wild is not: a feature's write-back switches between
the sum and the last writer on whether ≥ 2 of the round's δ are nonzero,
and a δ at a clipped bound is exactly 0 or about 1e-8 by one rounding.
A float32 difference in a dot (the two packages add in other orders)
therefore flips a feature now and then, and the solves part by up to
0.25 on ŵ within 5 epochs, as the reference's own dense and ELL paths
do.  So Wild is held over one epoch from α = 0 and, for 5 epochs, one
epoch at a time from the reference's state (ROADMAP C.5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import duals as rd
from repro.core import passcode as rp
from repro.core.dcd import DcdState as RefDcdState
from repro.core.dcd import dcd_epoch as ref_dcd_epoch
from repro.data import make_dataset
from repro_torch import prng
from repro_torch.convert import dense_from_numpy, ell_from_numpy
from repro_torch.core import duals as td
from repro_torch.core import passcode as tp
from repro_torch.core.dcd import DcdState, dcd_epoch
from repro_torch.core.objective import w_of_alpha

from test_torch_solver import ATOL, _gap_atol

LOSSES = {"hinge": (rd.Hinge(1.0), td.Hinge(1.0)),
          "squared_hinge": (rd.SquaredHinge(1.0), td.SquaredHinge(1.0)),
          "logistic": (rd.Logistic(0.5), td.Logistic(0.5))}


@pytest.fixture(scope="module", params=["tiny", "tiny-dense"])
def data(request):
    X = make_dataset(request.param).X_train
    idx, val = np.asarray(X.indices), np.asarray(X.values)
    dense = np.asarray(X.to_dense())
    return {"ell": (X, ell_from_numpy(idx, val, X.n_features, device="cpu")),
            "dense": (jnp.asarray(dense),
                      dense_from_numpy(dense, device="cpu"))}


def _key(k):
    return torch.from_numpy(np.asarray(k).astype(np.int64))


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def _assert_solve(p, r, Xp, loss):
    for port, ref in [(p.alpha, r.alpha), (p.w_hat, r.w_hat),
                      (p.w_bar, r.w_bar), (p.eps_norms, r.eps_norms)]:
        _close(port, ref)
    np.testing.assert_allclose(p.gaps.numpy(), np.asarray(r.gaps), rtol=0,
                               atol=_gap_atol(Xp, p.alpha, loss))
    assert p.epochs == r.epochs


@pytest.mark.parametrize("seed", [0, 5])
def test_round_schedule_and_conflict_draws_equal(seed):
    """Every round's schedule positions and conflict draw, batched over
    the epoch, are the reference's per-round ``split``/``permutation``/
    ``uniform``; the conflict masks built from them are equal exactly."""
    p, d, R = 8, 40, 6
    kround = jax.random.split(jax.random.PRNGKey(seed))[1]
    keys = jax.random.split(kround, R)
    pos, kconf = tp._round_schedule(_key(keys), p)
    rng = np.random.default_rng(seed)
    ind = torch.from_numpy(rng.integers(0, d + 1, (R, p, 5)))
    u_ell = tp._conflict_draws(kconf, lambda s, e: ind[s:e])
    ar = torch.arange(d)
    u_dense = tp._conflict_draws(kconf, lambda s, e: ar.expand(e - s, d))
    rate = torch.tensor(0.5)
    for r in range(R):
        korder, kc = jax.random.split(keys[r])
        np.testing.assert_array_equal(
            pos[r].numpy(), np.asarray(jax.random.permutation(korder, p)))
        u_ref = np.asarray(jax.random.uniform(kc, (d + 1,)))
        np.testing.assert_array_equal(u_dense[r].numpy(), u_ref[:d])
        np.testing.assert_array_equal(u_ell[r].numpy(),
                                      u_ref[ind[r].numpy()])
        # a writer pattern with some features hit twice or more
        writers = rng.random((p, 5)) < 0.7
        n_writers = np.zeros(d + 1, np.int64)
        np.add.at(n_writers, ind[r].numpy(), writers)
        want = (n_writers >= 2) & (u_ref < 0.5)
        got = tp._ell_conflicted(ind[r], torch.from_numpy(writers),
                                 u_ell[r], rate, d + 1)
        np.testing.assert_array_equal(got.numpy(), want)
        w_dense = rng.random((p, d)) < 0.2
        np.testing.assert_array_equal(
            tp._dense_conflicted(torch.from_numpy(w_dense), u_dense[r],
                                 rate).numpy(),
            (w_dense.sum(0) >= 2) & (u_ref[:d] < 0.5))


@pytest.mark.parametrize("layout", ["ell", "dense"])
@pytest.mark.parametrize("memory_model,delay", [
    ("lock", 0), ("lock", 2), ("atomic", 0), ("atomic", 2), ("wild", 0),
    ("wild", 2)])
def test_solve_matches_reference(data, layout, memory_model, delay):
    """Lock and Atomic over 5 epochs; Wild over one (module docstring)."""
    Xr, Xp = data[layout]
    epochs = 1 if memory_model == "wild" else 5
    kw = dict(n_threads=8, memory_model=memory_model, epochs=epochs,
              delay=delay, conflict_rate=0.5, seed=3)
    r = rp.passcode_solve(Xr, rd.Hinge(1.0), **kw)
    p = tp.passcode_solve(Xp, td.Hinge(1.0), device="cpu", **kw)
    _assert_solve(p, r, Xp, td.Hinge(1.0))


@pytest.mark.parametrize("layout", ["ell", "dense"])
@pytest.mark.parametrize("delay", [0, 2])
def test_wild_epochs_match_reference_from_its_state(data, layout, delay):
    """Five Wild epochs, each from the reference's (α, ŵ) and subkey."""
    Xr, Xp = data[layout]
    ell = layout == "ell"
    sq_r = Xr.row_sq_norms() if ell else jnp.sum(Xr * Xr, axis=1)
    sq_p = Xp.row_sq_norms() if ell else torch.sum(Xp * Xp, dim=1)
    n = Xp.n_rows if ell else Xp.shape[0]
    d = Xp.n_features if ell else Xp.shape[1]
    key = jax.random.PRNGKey(4)
    alpha, w = jnp.zeros(n), jnp.zeros(d)
    kw = dict(n_threads=8, memory_model="wild", delay=delay,
              conflict_rate=0.8)
    for _ in range(5):
        key, sub = jax.random.split(key)
        pa, pw = tp.passcode_epoch(
            Xp, sq_p, torch.from_numpy(np.array(alpha)),
            torch.from_numpy(np.array(w)), _key(sub), td.Hinge(1.0),
            device="cpu", **kw)
        alpha, w = rp.passcode_epoch(Xr, sq_r, alpha, w, sub, rd.Hinge(1.0),
                                     **kw)
        _close(pa, alpha)
        _close(pw, w)
    # conflicts struck: ŵ has drifted from w̄
    assert float(torch.linalg.norm(w_of_alpha(Xp, pa) - pw)) > 0.1


@pytest.mark.parametrize("layout", ["ell", "dense"])
@pytest.mark.parametrize("loss", ["squared_hinge", "logistic"])
def test_atomic_other_losses_match_reference(data, layout, loss):
    Xr, Xp = data[layout]
    ref_loss, port_loss = LOSSES[loss]
    kw = dict(n_threads=4, memory_model="atomic", epochs=3, delay=1, seed=2)
    r = rp.passcode_solve(Xr, ref_loss, **kw)
    p = tp.passcode_solve(Xp, port_loss, device="cpu", **kw)
    _assert_solve(p, r, Xp, port_loss)


def test_lock_equals_serial_sequence(tiny_dense, hinge):
    """The twin of ``tests/test_passcode.py::test_lock_equals_serial_
    sequence``: a Lock epoch is serial DCD over its rounds' order (the
    same bits), and both are the reference's serial epoch."""
    X = tiny_dense
    n, d = X.shape
    key = jax.random.PRNGKey(3)
    rounds = rp._round_indices(jax.random.split(key)[0], n, 8)
    st = ref_dcd_epoch(X, jnp.sum(X * X, axis=1),
                       RefDcdState(jnp.zeros(n), jnp.zeros(d)),
                       rounds.reshape(-1), hinge)
    Xp = dense_from_numpy(np.asarray(X), device="cpu")
    sq_p = torch.sum(Xp * Xp, dim=1)
    rounds_p = tp._round_indices(prng.split(_key(key))[0], n, 8)
    np.testing.assert_array_equal(rounds_p.numpy(), np.asarray(rounds))
    serial = dcd_epoch(Xp, sq_p, DcdState(torch.zeros(n), torch.zeros(d)),
                       rounds_p.reshape(-1).int(), td.Hinge(1.0))
    alpha, w = tp.passcode_epoch(Xp, sq_p, torch.zeros(n), torch.zeros(d),
                                 _key(key), td.Hinge(1.0), n_threads=8,
                                 memory_model="lock", device="cpu")
    assert torch.equal(alpha, serial.alpha) and torch.equal(w, serial.w)
    _close(alpha, st.alpha)
    _close(w, st.w)


def test_record_off_and_tol(data):
    _, Xp = data["ell"]
    r = tp.passcode_solve(Xp, td.Hinge(1.0), epochs=2, record=False,
                          device="cpu")
    assert r.epochs == 2 and r.gaps.numel() == 0 and r.eps_norms.numel() == 0
    r = tp.passcode_solve(Xp, td.Hinge(1.0), epochs=50, tol=1e9,
                          device="cpu")
    assert r.epochs == 1 and r.gaps.shape == (1,)


@pytest.mark.parametrize("kw,match", [
    (dict(memory_model="racy"), "memory_model"),
    (dict(n_threads=0), "n_threads"),
    (dict(delay=-1), "delay"),
])
def test_bad_knobs_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        tp.passcode_solve(torch.ones((4, 2)), td.Hinge(), epochs=1,
                          device="cpu", **kw)
