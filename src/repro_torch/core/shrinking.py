"""Shrinking heuristic (paper §3.3; Hsieh et al. 2008) — the counterpart
of ``repro/core/shrinking.py``.

A coordinate is frozen when it sits at a bound with a projected gradient
pointing out of the box by more than ``shrink_tol``; frozen coordinates
take a zero-delta update (the kernels' ``active`` operand).  Shapes stay
fixed: the mask is a tensor of the α's shape.  The mask is recomputed
every ``shrink_every`` epochs from fresh gradients, and the final epoch
runs a full unmasked pass, LIBLINEAR's safeguard.

``dcd_solve_shrink`` is the serial oracle the sharded solver's shrinking
is held to: the reference's p = 1 draw (``key, sub = split(key)``, then
``permutation(split(sub, 1)[0], n)``), the primal maintained through the
updates, and the same recompute and final-pass schedule.  An epoch is one
launch of the dense indexed kernel (B2) with the mask as its ``active``
operand on the card, or its plain version on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core.duals import Hinge, SquaredHinge
from repro_torch.core.objective import duality_gap
from repro_torch.dist.mesh import resolve_device
from repro_torch.kernels.dcd_block import dcd_indexed_epoch


def active_mask(loss, alpha, grads, shrink_tol: float):
    """True where the coordinate must stay active; elementwise, so it
    runs on a shard's α as on the whole vector."""
    if isinstance(loss, Hinge):
        at_lo = (alpha <= 0.0) & (grads > shrink_tol)
        at_hi = (alpha >= loss.C) & (grads < -shrink_tol)
        return ~(at_lo | at_hi)
    if isinstance(loss, SquaredHinge):
        return ~((alpha <= 0.0) & (grads > shrink_tol))
    return torch.ones_like(alpha, dtype=torch.bool)  # logistic: interior


def active_mask_from_w(loss, alpha, wx, shrink_tol: float):
    """``active_mask`` from the per-row dots ``wx = wᵀx_i``."""
    return active_mask(loss, alpha, loss.dual_grad(alpha, wx), shrink_tol)


def dcd_solve_shrink(X, loss, *, epochs: int = 20, seed: int = 0,
                     shrink_tol: float = 1e-3, shrink_every: int = 1,
                     unshrink: bool = True, device=None):
    """Serial DCD on a dense (n, d) X with the shrinking mask; returns
    (α, w, gaps, active fraction per epoch).  ``w`` is the primal
    maintained through the updates; ``unshrink`` runs the final epoch
    unmasked."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev).contiguous()
    n, d = X.shape
    shrink_every = max(int(shrink_every), 1)
    sq_norms = torch.sum(X * X, dim=1)
    alpha = torch.zeros((n,), dtype=torch.float32, device=dev)
    w = torch.zeros((d,), dtype=torch.float32, device=dev)
    key = prng.PRNGKey(seed, device=dev)
    mask = torch.ones((n,), dtype=torch.bool, device=dev)
    gaps, act = [], []
    for e in range(epochs):
        key, sub = prng.split(key)
        perm = prng.permutation(prng.split(sub, 1)[0], n).int()
        if e % shrink_every == 0:
            mask = active_mask_from_w(loss, alpha, X @ w, shrink_tol)
        run = mask
        if unshrink and e == epochs - 1:
            run = torch.ones_like(mask)  # final full pass
        alpha, w = dcd_indexed_epoch(X, alpha, w, sq_norms, loss=loss,
                                     idx=perm, active=run.float())
        gaps.append(duality_gap(alpha, X, loss))
        act.append(torch.mean(mask.float()))
    return alpha, w, torch.stack(gaps), torch.stack(act)
