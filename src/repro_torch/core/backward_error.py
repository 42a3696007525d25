"""Backward-error analysis for PASSCoDe-Wild (paper §4.2, Thm 3, Cor 1),
the counterpart of ``repro/core/backward_error.py``.

At the Wild fixpoint the outputs (ŵ, α̂) generally violate eq. (3):
ŵ ≠ w̄ := Σ α̂_i x_i.  Theorem 3 says (α̂, w̄) solve a *perturbed*
problem whose perturbation is exactly ε = w̄ − ŵ, and Corollary 1 says ŵ
is the exact minimizer of ½(w+ε)ᵀ(w+ε) + Σℓ_i(wᵀx_i) — hence **predict
with ŵ**.  The report checks (a) the fixpoint residual against ŵ (the
perturbed dual's optimality), against w̄ for contrast, and (c) the
accuracies of ŵ and w̄ (Table 2).

Every quantity is formed on the device of its tensors; the report's
fields are Python floats.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.objective import (
    _matvec,
    duality_gap,
    perturbed_primal_objective,
    predict_accuracy,
    primal_objective,
    w_of_alpha,
)
from repro_torch.data.sparse import EllMatrix


def fixpoint_residual(X, loss, alpha, w):
    """max_i |Δα_i| for one exact coordinate solve of (5) against w.

    Zero ⇔ (α, w) is a PASSCoDe fixpoint ⇔ −wᵀx_i ∈ ∂ℓ*(−α_i) ∀i
    (the optimality condition of the perturbed dual (14) with
    ε = w̄ − w).
    """
    sq = X.row_sq_norms() if isinstance(X, EllMatrix) else torch.sum(
        X * X, dim=1)
    deltas = loss.delta(alpha, _matvec(X, w), sq)
    return torch.max(torch.abs(deltas))


def backward_error_report(X, X_test, loss, result) -> Dict[str, Any]:
    """Full §4.2 report for a ``PasscodeResult`` (any memory model; for
    lock/atomic ε ≈ 0 and the report degenerates gracefully).
    ``X_test`` may be None."""
    alpha, w_hat = result.alpha, result.w_hat
    w_bar = w_of_alpha(X, alpha)
    eps = w_bar - w_hat
    report = {
        "eps_norm": float(torch.linalg.norm(eps)),
        "w_bar_norm": float(torch.linalg.norm(w_bar)),
        "w_hat_norm": float(torch.linalg.norm(w_hat)),
        # (a) — perturbed-dual optimality (Thm 3).
        "fixpoint_residual_w_hat": float(
            fixpoint_residual(X, loss, alpha, w_hat)),
        # For contrast: the *nominal* residual against w̄ (nonzero for
        # wild).
        "fixpoint_residual_w_bar": float(
            fixpoint_residual(X, loss, alpha, w_bar)),
        # Perturbed primal value at ŵ (Cor 1) vs nominal primal values.
        "perturbed_primal_at_w_hat": float(
            perturbed_primal_objective(w_hat, X, loss, eps)),
        "primal_at_w_hat": float(primal_objective(w_hat, X, loss)),
        "primal_at_w_bar": float(primal_objective(w_bar, X, loss)),
        "nominal_duality_gap": float(duality_gap(alpha, X, loss)),
        # (c) — Table 2.
        "train_acc_w_hat": float(predict_accuracy(w_hat, X)),
        "train_acc_w_bar": float(predict_accuracy(w_bar, X)),
    }
    if X_test is not None:
        report["test_acc_w_hat"] = float(predict_accuracy(w_hat, X_test))
        report["test_acc_w_bar"] = float(predict_accuracy(w_bar, X_test))
    return report
