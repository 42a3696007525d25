"""repro_torch.core.duals against repro.core.duals: δ, conj, primal loss
and dual_grad for the three losses on one numpy grid of (α, wx, q) that
includes the box edges.  atol 1e-6 (float32 on both sides; logistic's
20 Newton steps use each framework's own log)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import duals as rd
from repro_torch.core import duals as td

LOSSES = [
    ("hinge", 1.0), ("hinge", 0.0625), ("squared_hinge", 1.0),
    ("squared_hinge", 2.0), ("logistic", 1.0), ("logistic", 0.25),
]


def _grid(C):
    """Every (α, wx, q) combination: α on the box edges and inside, wx
    around the margin, q from the ε floor to well above 1."""
    alphas = np.array([0.0, 1e-7 * C, 0.1 * C, 0.5 * C, 0.9 * C,
                       (1 - 1e-7) * C, C], np.float32)
    wxs = np.array([-3.0, -1.0, 0.0, 0.5, 1.0, 1.5, 4.0], np.float32)
    qs = np.array([0.0, 1e-13, 1e-3, 0.3, 1.0, 2.5], np.float32)
    a, wx, q = (np.array(v, np.float32)
                for v in zip(*itertools.product(alphas, wxs, qs)))
    return a, wx, q


def _pair(name, C):
    return rd.make_loss(name, C), td.make_loss(name, C)


def _close(ref, port, atol=1e-6):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("name,C", LOSSES)
def test_delta_matches_reference(name, C):
    ref, port = _pair(name, C)
    a, wx, q = _grid(C)
    if name == "logistic":  # the Newton domain is the open box (0, C)
        keep = (a > 0) & (a < C)
        a, wx, q = a[keep], wx[keep], q[keep]
    _close(ref.delta(jnp.asarray(a), jnp.asarray(wx), jnp.asarray(q)),
           port.delta(torch.from_numpy(a), torch.from_numpy(wx),
                      torch.from_numpy(q)))


@pytest.mark.parametrize("name,C", LOSSES)
def test_conj_primal_and_grad_match_reference(name, C):
    ref, port = _pair(name, C)
    a, wx, _ = _grid(C)
    z = np.linspace(-6, 6, 97, dtype=np.float32)
    _close(ref.conj(jnp.asarray(a)), port.conj(torch.from_numpy(a)))
    _close(ref.primal_loss(jnp.asarray(z)),
           port.primal_loss(torch.from_numpy(z)))
    _close(ref.dual_grad(jnp.asarray(a), jnp.asarray(wx)),
           port.dual_grad(torch.from_numpy(a), torch.from_numpy(wx)))
    _close(ref.feasible(jnp.asarray(a * 1.5 - 0.2 * C)),
           port.feasible(torch.from_numpy(a * 1.5 - 0.2 * C)))


@pytest.mark.parametrize("name,C", LOSSES)
def test_kernel_params_constants(name, C):
    """The constants the CUDA δ takes are the float32 roundings the plain
    δ uses."""
    kind, c, inv2c, epsc, steps = td.kernel_params(td.make_loss(name, C))
    assert kind == {"hinge": 0, "squared_hinge": 1, "logistic": 2}[name]
    assert c == C and inv2c == 1.0 / (2.0 * C) and epsc == 1e-12 * C
    assert steps == (20 if name == "logistic" else 0)
