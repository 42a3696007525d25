"""Serial Stochastic Dual Coordinate Descent — Algorithm 1 (LIBLINEAR),
the counterpart of ``repro/core/dcd.py``.

The inner loop maintains w(α) = Σ α_i x_i so one update costs O(nnz/n)
(sparse) / O(d) (dense).  Index order is a random permutation per epoch
(paper §3.3, sampling without replacement), drawn through the
reference's ``jax.random`` key chain, bit-exact (``repro_torch.prng``:
``key = PRNGKey(seed)``, per epoch ``key, sub = split(key)`` and
``permutation(sub, n)``), or taken from ``perms=`` as an explicit
schedule.

An epoch is one launch of the indexed kernel in permutation order
(B1 for ``EllMatrix``, B2 for dense) on the card, or the kernel's plain
version on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import prng
from repro_torch.core.objective import duality_gap, w_of_alpha
from repro_torch.data.sparse import EllMatrix, pad_primal, unpad_primal
from repro_torch.dist.mesh import resolve_device
from repro_torch.kernels.dcd_block import dcd_indexed_epoch
from repro_torch.kernels.dcd_ell import dcd_ell_epoch


class DcdState(NamedTuple):
    alpha: torch.Tensor  # (n,)
    w: torch.Tensor  # (d,) — maintained primal (eq. 3)


def dcd_epoch(X, sq_norms, state: DcdState, perm, loss) -> DcdState:
    """One epoch: n coordinate updates in ``perm`` (int32) order."""
    if isinstance(X, EllMatrix):
        alpha, w_pad = dcd_ell_epoch(X.indices, X.values, state.alpha,
                                     pad_primal(state.w), sq_norms,
                                     loss=loss, idx=perm)
        return DcdState(alpha, unpad_primal(w_pad))
    return DcdState(*dcd_indexed_epoch(X, state.alpha, state.w, sq_norms,
                                       loss=loss, idx=perm))


class DcdResult(NamedTuple):
    alpha: torch.Tensor
    w: torch.Tensor
    gaps: torch.Tensor  # duality gap after each epoch
    epochs: int


def dcd_solve(X, loss, *, epochs: int = 20, seed: int = 0, tol: float = 0.0,
              alpha0=None, record_gap: bool = True, perms=None,
              device=None) -> DcdResult:
    """Run serial DCD for ``epochs`` epochs (early stop on duality gap ≤
    tol), in the reference's seeded order.  ``perms`` (epochs, n)
    replaces the seeded draw with an explicit schedule."""
    dev = resolve_device(device)
    if isinstance(X, EllMatrix):
        X = X.to(dev)
        n, d = X.n_rows, X.n_features
        sq_norms = X.row_sq_norms()
    else:
        X = torch.as_tensor(X, dtype=torch.float32, device=dev).contiguous()
        n, d = X.shape
        sq_norms = torch.sum(X * X, dim=1)
    if perms is not None:
        perms = torch.as_tensor(perms, dtype=torch.int32, device=dev)
        if perms.shape != (epochs, n):
            raise ValueError(f"perms must have shape ({epochs}, {n})")
        if epochs and not (0 <= int(perms.min()) and int(perms.max()) < n):
            raise ValueError(f"perms must hold row ids in [0, {n})")
    if alpha0 is None:
        alpha = torch.zeros((n,), dtype=torch.float32, device=dev)
        w = torch.zeros((d,), dtype=torch.float32, device=dev)
    else:
        alpha = loss.feasible(torch.as_tensor(alpha0, dtype=torch.float32,
                                              device=dev))
        w = w_of_alpha(X, alpha)
    state = DcdState(alpha, w)
    key = prng.PRNGKey(seed, device=dev)
    gaps = []
    done = 0
    for e in range(epochs):
        key, sub = prng.split(key)
        perm = (perms[e] if perms is not None else
                prng.permutation(sub, n).int())
        state = dcd_epoch(X, sq_norms, state, perm, loss)
        done = e + 1
        if record_gap:
            g = float(duality_gap(state.alpha, X, loss))
            gaps.append(g)
            if tol > 0 and g <= tol:
                break
    return DcdResult(state.alpha, state.w,
                     torch.tensor(gaps, dtype=torch.float32), done)
