"""``repro_torch.core.backward_error`` and
``objective.perturbed_primal_objective`` against the reference (CPU).

Each report is taken of the same (α, ŵ) in both packages — a Wild
result of the reference, carried across — so the fields compare the
report alone; a second case reports the port's own one-epoch solve
against the reference's.  Fields at rtol 1e-5 / atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import passcode_solve as ref_passcode_solve
from repro.core import duals as rd
from repro.core.backward_error import backward_error_report as ref_report
from repro.core.backward_error import fixpoint_residual as ref_residual
from repro.core.objective import perturbed_primal_objective as ref_perturbed
from repro.data import make_dataset
from repro_torch.convert import dense_from_numpy, ell_from_numpy
from repro_torch.core import duals as td
from repro_torch.core.backward_error import (
    backward_error_report,
    fixpoint_residual,
)
from repro_torch.core.objective import perturbed_primal_objective
from repro_torch.core.passcode import PasscodeResult, passcode_solve

LOSSES = {"hinge": (rd.Hinge(1.0), td.Hinge(1.0)),
          "logistic": (rd.Logistic(0.5), td.Logistic(0.5))}


@pytest.fixture(scope="module")
def tiny():
    ds = make_dataset("tiny")
    X, Xt = ds.X_train, ds.X_test

    def port(M, ell):
        if ell:
            return ell_from_numpy(np.asarray(M.indices), np.asarray(M.values),
                                  M.n_features, device="cpu")
        return dense_from_numpy(np.asarray(M.to_dense()), device="cpu")

    return {ell: ((X if ell else X.to_dense(), Xt if ell else Xt.to_dense()),
                  (port(X, ell), port(Xt, ell)))
            for ell in (True, False)}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _assert_report(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("ell", [True, False], ids=["ell", "dense"])
@pytest.mark.parametrize("loss", ["hinge", "logistic"])
@pytest.mark.parametrize("with_test", [True, False])
def test_report_of_the_same_state_matches(tiny, ell, loss, with_test):
    (Xr, Xtr), (Xp, Xtp) = tiny[ell]
    ref_loss, port_loss = LOSSES[loss]
    r = ref_passcode_solve(Xr, ref_loss, n_threads=8, memory_model="wild",
                           epochs=4, conflict_rate=0.7, seed=1)
    want = ref_report(Xr, Xtr if with_test else None, ref_loss, r)
    p = PasscodeResult(_t(r.alpha), _t(r.w_hat), _t(r.w_bar), _t(r.gaps),
                       _t(r.eps_norms), r.epochs)
    got = backward_error_report(Xp, Xtp if with_test else None, port_loss, p)
    _assert_report(got, want)
    assert want["eps_norm"] > 0.1  # a real perturbation


@pytest.mark.parametrize("ell", [True, False], ids=["ell", "dense"])
@pytest.mark.parametrize("memory_model", ["atomic", "wild"])
def test_report_of_the_ports_solve_matches(tiny, ell, memory_model):
    (Xr, Xtr), (Xp, Xtp) = tiny[ell]
    kw = dict(n_threads=8, memory_model=memory_model, epochs=1, seed=2)
    want = ref_report(Xr, Xtr, rd.Hinge(1.0),
                      ref_passcode_solve(Xr, rd.Hinge(1.0), **kw))
    got = backward_error_report(Xp, Xtp, td.Hinge(1.0),
                                passcode_solve(Xp, td.Hinge(1.0),
                                               device="cpu", **kw))
    _assert_report(got, want)


@pytest.mark.parametrize("ell", [True, False], ids=["ell", "dense"])
def test_perturbed_primal_and_residual_match(tiny, ell):
    (Xr, _), (Xp, _) = tiny[ell]
    d = Xp.n_features if ell else Xp.shape[1]
    n = Xp.n_rows if ell else Xp.shape[0]
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(d) * 0.3).astype(np.float32)
    eps = (rng.standard_normal(d) * 0.1).astype(np.float32)
    alpha = rng.uniform(0.0, 1.0, n).astype(np.float32)
    for ref_loss, port_loss in LOSSES.values():
        np.testing.assert_allclose(
            float(perturbed_primal_objective(_t(w), Xp, port_loss, _t(eps))),
            float(ref_perturbed(jnp.asarray(w), Xr, ref_loss,
                                jnp.asarray(eps))), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            float(fixpoint_residual(Xp, port_loss, _t(alpha), _t(w))),
            float(ref_residual(Xr, ref_loss, jnp.asarray(alpha),
                               jnp.asarray(w))), rtol=1e-5, atol=1e-5)
