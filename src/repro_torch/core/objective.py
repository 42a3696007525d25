"""Primal/dual objectives, duality gap, prediction accuracy — the
counterpart of ``repro/core/objective.py``.

Works on dense (n, d) tensors or ``EllMatrix``.  Rows are label-folded
(x_i = y_i·ẋ_i), so classification is correct iff wᵀx_i > 0 and binary
accuracy needs no separate label vector.
"""

from __future__ import annotations

import torch

from repro_torch.data.sparse import EllMatrix, ell_matvec, ell_rmatvec


def _matvec(X, w):
    if isinstance(X, EllMatrix):
        return ell_matvec(X, w)
    return X @ w


def _rmatvec(X, alpha):
    if isinstance(X, EllMatrix):
        return ell_rmatvec(X, alpha)
    return X.T @ alpha


def w_of_alpha(X, alpha):
    """w(α) = Σ_i α_i x_i  (eq. 3)."""
    return _rmatvec(X, alpha)


def primal_objective(w, X, loss):
    """P(w) = ½‖w‖² + Σ ℓ_i(wᵀx_i)  (eq. 1)."""
    z = _matvec(X, w)
    return 0.5 * torch.dot(w, w) + torch.sum(loss.primal_loss(z))


def dual_objective(alpha, X, loss):
    """D(α) = ½‖Σ α_i x_i‖² + Σ ℓ*(−α_i)  (eq. 2)."""
    w = _rmatvec(X, alpha)
    return 0.5 * torch.dot(w, w) + torch.sum(loss.conj(alpha))


def duality_gap(alpha, X, loss):
    """P(w(α)) + D(α) ≥ 0, → 0 at optimum (P(w*) = −D(α*))."""
    w = _rmatvec(X, alpha)
    return primal_objective(w, X, loss) + dual_objective(alpha, X, loss)


def predict_accuracy(w, X):
    """Fraction of rows with wᵀx_i > 0 (x_i is label-folded)."""
    z = _matvec(X, w)
    return torch.mean((z > 0).to(torch.float32))
