"""The port's data layer and objectives against the reference:
``data/synthetic.py`` bit-equal to ``repro.data.make_dataset``, the
on-device Table-3 draw's law, the ELL core of ``data/sparse.py`` and
``core/objective.py`` (atol 1e-5, plus rtol 1e-6 — 8 float32 ulps —
for objective values of order 100: float32 sums in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import duals as rd
from repro.core import objective as ro
from repro.data import make_dataset as jax_make_dataset
from repro.data import sparse as rsp
from repro_torch.convert import dense_from_numpy, ell_from_numpy
from repro_torch.core import duals as td
from repro_torch.core import objective as to
from repro_torch.data import sparse as tsp
from repro_torch.data.synthetic import (
    DatasetRecipe,
    make_dataset,
    make_paper_split,
)

ATOL = 1e-5


@pytest.mark.parametrize("name", ["tiny", "tiny-dense", "covtype", "news20",
                                  "rcv1"])
def test_recipes_bit_equal_reference(name):
    """Every recipe at or below the rcv1 recipe's size."""
    ref = jax_make_dataset(name, seed=3)
    port = make_dataset(name, seed=3, device="cpu")
    np.testing.assert_array_equal(port.w_true, ref.w_true)
    for r, p in [(ref.X_train, port.X_train), (ref.X_test, port.X_test)]:
        np.testing.assert_array_equal(p.indices.numpy(),
                                      np.asarray(r.indices))
        np.testing.assert_array_equal(p.values.numpy().view(np.int32),
                                      np.asarray(r.values).view(np.int32))
        assert p.n_features == r.n_features


@pytest.mark.parametrize("k", [12, 40])
def test_paper_split_law(k):
    """The on-device draw at a small shape: distinct zipf-skewed columns,
    unit-norm folded rows, labels that mostly agree with w_true."""
    recipe = DatasetRecipe("r", 4000, 0, 40 if k == 40 else 300, k, 1.0)
    X, w_true = make_paper_split("rcv1", seed=1, device="cpu", recipe=recipe)
    if k == 40:  # dense
        assert X.shape == (4000, 40)
        norms, margins = X.norm(dim=1), X @ w_true
    else:
        assert X.indices.shape == (4000, k) and X.indices.dtype == torch.int32
        srt = X.indices.sort(dim=1).values
        assert bool((srt.diff(dim=1) > 0).all())  # no repeated column
        counts = torch.bincount(X.indices.reshape(-1).long(), minlength=300)
        assert counts[:10].sum() > counts[-10:].sum() * 3  # zipf skew
        norms = X.values.norm(dim=1)
        margins = to.predict_accuracy(w_true, X)
    torch.testing.assert_close(norms, torch.ones_like(norms))
    acc = float((margins > 0).float().mean()) if k == 40 else float(margins)
    assert acc > 0.75  # folded labels follow the margin up to 2% noise
    again, _ = make_paper_split("rcv1", seed=1, device="cpu", recipe=recipe)
    a = again if k == 40 else again.values
    b = X if k == 40 else X.values
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def ragged():
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((30, 17)).astype(np.float32)
    dense[rng.random((30, 17)) < 0.6] = 0.0
    dense[4] = 0.0  # an empty row
    return dense


def test_dense_to_ell_and_row_ops_match_reference(ragged):
    ref = rsp.dense_to_ell(ragged, k_max=15)
    port = tsp.dense_to_ell(ragged, k_max=15, device="cpu")
    np.testing.assert_array_equal(port.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(port.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(port.to_dense().numpy(), ragged)
    np.testing.assert_allclose(port.row_sq_norms().numpy(),
                               np.asarray(ref.row_sq_norms()), atol=ATOL)
    w = np.linspace(-1, 1, 17).astype(np.float32)
    wp_r = rsp.pad_primal(jnp.asarray(w))
    wp_p = tsp.pad_primal(torch.from_numpy(w))
    np.testing.assert_array_equal(wp_p.numpy(), np.asarray(wp_r))
    np.testing.assert_array_equal(tsp.unpad_primal(wp_p).numpy(), w)
    for i in (0, 4, 29):
        np.testing.assert_allclose(
            float(tsp.ell_row_dot(port, wp_p, i)),
            float(rsp.ell_row_dot(ref, wp_r, i)), atol=ATOL)
        np.testing.assert_allclose(
            tsp.ell_row_axpy(port, wp_p, i, 0.3).numpy(),
            np.asarray(rsp.ell_row_axpy(ref, wp_r, i, 0.3)), atol=ATOL)
    with pytest.raises(ValueError, match="k_max"):
        tsp.dense_to_ell(ragged, k_max=2, device="cpu")


@pytest.mark.parametrize("loss", ["hinge", "squared_hinge", "logistic"])
def test_objectives_match_reference(ragged, loss):
    ref_X = rsp.dense_to_ell(ragged)
    Xe = ell_from_numpy(np.asarray(ref_X.indices), np.asarray(ref_X.values),
                        17, device="cpu")
    Xd = dense_from_numpy(ragged, device="cpu")
    rng = np.random.default_rng(1)
    alpha = rng.uniform(0.01, 0.9, 30).astype(np.float32)
    w = (rng.standard_normal(17) * 0.3).astype(np.float32)
    rl, pl = rd.make_loss(loss), td.make_loss(loss)
    a_t, w_t = torch.from_numpy(alpha), torch.from_numpy(w)
    for Xr, Xp in [(ref_X, Xe), (jnp.asarray(ragged), Xd)]:
        pairs = [
            (ro.w_of_alpha(Xr, jnp.asarray(alpha)), to.w_of_alpha(Xp, a_t)),
            (ro.primal_objective(jnp.asarray(w), Xr, rl),
             to.primal_objective(w_t, Xp, pl)),
            (ro.dual_objective(jnp.asarray(alpha), Xr, rl),
             to.dual_objective(a_t, Xp, pl)),
            (ro.duality_gap(jnp.asarray(alpha), Xr, rl),
             to.duality_gap(a_t, Xp, pl)),
            (ro.predict_accuracy(jnp.asarray(w), Xr),
             to.predict_accuracy(w_t, Xp)),
        ]
        for r, p in pairs:
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=ATOL)


def test_convert_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        ell_from_numpy(np.zeros((3, 2)), np.zeros((3, 4)), 5, device="cpu")
