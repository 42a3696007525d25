"""Plain-torch oracle for the in-order DCD epoch (B3) — the counterpart
of ``repro/kernels/ref.py``.

Semantics: sequential coordinate updates over rows 0..n-1 **in order**
for the hinge / squared-hinge closed forms selected by the legacy
``C``/``sq_hinge`` flags.  This is Algorithm 1 with the identity
permutation, written independently of ``repro_torch.core.duals``.
"""

from __future__ import annotations

import torch


def _delta(alpha_i, wx, q, c, sq_hinge: bool):
    if sq_hinge:
        denom = q + 1.0 / (2.0 * c)
        new = torch.clamp(alpha_i + (1.0 - wx - alpha_i / (2.0 * c)) / denom,
                          min=0.0)
    else:
        new = torch.clamp(alpha_i + (1.0 - wx) / torch.clamp(q, min=1e-12),
                          0.0, c)
    return new - alpha_i


def dcd_epoch_ref(X, alpha, w, sq_norms, C, sq_hinge: bool = False):
    """One in-order epoch. X: (n, d) dense; returns new (alpha, w)."""
    alpha, w = alpha.clone(), w.clone()
    for t in range(X.shape[0]):
        x = X[t]
        d = _delta(alpha[t], torch.dot(w, x), sq_norms[t], C, sq_hinge)
        alpha[t] = alpha[t] + d
        w = w + d * x
    return alpha, w
