"""Primal/dual objectives, duality gap, prediction accuracy — the
counterpart of ``repro/core/objective.py``.

Works on dense (n, d) tensors or ``EllMatrix``.  Rows are label-folded
(x_i = y_i·ẋ_i), so classification is correct iff wᵀx_i > 0 and binary
accuracy needs no separate label vector.  The multiclass helpers
(``predict_multiclass``/``multiclass_accuracy``) take a (K, d)
one-vs-rest weight stack over unfolded rows and integer class ids, the
shapes the multi-task solver produces.
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


def perturbed_primal_objective(w, X, loss, eps):
    """Eq. (16): ½(w+ε)ᵀ(w+ε) + Σ ℓ_i(wᵀx_i) — the problem ŵ exactly
    solves under PASSCoDe-Wild (Corollary 1)."""
    z = _matvec(X, w)
    we = w + eps
    return 0.5 * torch.dot(we, we) + torch.sum(loss.primal_loss(z))


def predict_accuracy(w, X):
    """Fraction of rows with wᵀx_i > 0 (x_i is label-folded)."""
    z = _matvec(X, w)
    return torch.mean((z > 0).to(torch.float32))


def predict_multiclass(W, X):
    """Argmax class ids over a (K, d) one-vs-rest weight stack (or
    (K, d + 1) heads whose last word is the ELL dummy slot).  ``X``
    holds unfolded rows, dense or ELL.  Returns (n,) int32: row i goes
    to the head with the largest margin w_kᵀx_i (the first on a tie).
    The heads are scored one at a time, so no (K, nnz) temporary is
    formed."""
    W = torch.as_tensor(W, dtype=torch.float32)
    if W.dim() != 2:
        raise ValueError(f"expected a (K, d) weight stack, got "
                         f"{tuple(W.shape)}")
    d = X.n_features if isinstance(X, EllMatrix) else X.shape[1]
    if W.shape[1] not in (d, d + 1):
        raise ValueError(f"heads of {W.shape[1]} words for {d} features")
    W = W.to(X.device)
    scores = torch.stack([_matvec(X, w[:d]) for w in W])  # (K, n)
    return torch.argmax(scores, dim=0).to(torch.int32)


def multiclass_accuracy(W, X, y_int):
    """Top-1 accuracy of the (K, d) stack against integer class ids."""
    pred = predict_multiclass(W, X)
    y = torch.as_tensor(y_int, device=pred.device)
    return torch.mean((pred == y).to(torch.float32))
