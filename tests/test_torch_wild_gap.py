"""Wild's nominal gap at rcv1's width: ``repro`` and ``repro_torch`` on
the same rows (``scripts/wild_gap_growth.py``, CPU).

One PASSCoDe-Wild epoch's duality gap is w̄'s (eq. 6), and w̄ runs ahead
of the ŵ the updates read; on rcv1's zipf-hot columns the gap after one
epoch grows with n relative to the gap at α = 0 (past it at n = 100,000:
1.90 in both packages, by the script).  ``chip_smoke.py`` therefore holds
Wild on rcv1 to P(ŵ) < P(0) rather than to a falling gap.  Here the
port is held to the reference epoch by epoch at 4,000 and 20,000 rows
(atol 1e-5 on α, ŵ, w̄; the gap at 1e-5 + 1e-6·M, ROADMAP C.2), and the
growth of Wild's gap ratio is shown in both.

w̄ and the gap are sums over all n rows, which the two packages add in
float32 in other orders (at 4,000 rows the reference's float32 gap lies
0.03 from the float64 value at its own α, the port's 3e-4), so they are
held through one float64 evaluation of each package's α; α and ŵ, the
state the epoch computes, are held as they come.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_solver import ATOL, _gap_atol

from repro_torch.core import duals as td
from repro_torch.core.objective import duality_gap, w_of_alpha
from repro_torch.data.sparse import EllMatrix

ROWS = (4_000, 20_000)
_SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "wild_gap_growth.py"


@pytest.fixture(scope="module")
def growth():
    spec = importlib.util.spec_from_file_location("wild_gap_growth", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {n: mod.solve_both(n) for n in ROWS}


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("memory_model", ["atomic", "wild"])
def test_epoch_at_rcv1_width_matches_reference(growth, n, memory_model):
    Xp, _, runs = growth[n]
    r, p = runs[memory_model]
    for port, ref in [(p.alpha, r.alpha), (p.w_hat, r.w_hat)]:
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)
    X64 = EllMatrix(Xp.indices, Xp.values.double(), Xp.n_features)
    a_p = p.alpha.double()
    a_r = torch.from_numpy(np.asarray(r.alpha, dtype=np.float64))
    np.testing.assert_allclose(w_of_alpha(X64, a_p).numpy(),
                               w_of_alpha(X64, a_r).numpy(), rtol=0,
                               atol=ATOL)
    loss = td.Hinge(1.0)
    assert abs(float(duality_gap(a_p, X64, loss))
               - float(duality_gap(a_r, X64, loss))) <= _gap_atol(
                   Xp, p.alpha, loss)

@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_wild_gap_ratio_grows_with_n(growth, package):
    """Wild's gap over the gap at α = 0 rises from 4,000 to 20,000 rows;
    Atomic's stays well below 1."""
    i = 0 if package == "repro" else 1

    def ratio(n, mm):
        _, gap0, runs = growth[n]
        return float(runs[mm][i].gaps[0]) / gap0[package]

    lo, hi = ratio(ROWS[0], "wild"), ratio(ROWS[1], "wild")
    assert hi > lo, (lo, hi)
    assert all(ratio(n, "atomic") < 0.5 < ratio(n, "wild") for n in ROWS)
