"""AsySCD (Liu & Wright, 2014; Liu et al., 2014), the baseline of the
paper's §5, the counterpart of ``repro/core/asyscd.py``.

Asynchronous stochastic projected-gradient coordinate descent on the
dual, *without* maintaining w: each coordinate step needs ∇_i D(α) =
x_iᵀ(Xᵀα) − 1 (hinge), an O(nnz) product.  As in the reference, w̄ =
Xᵀα is formed once a round of ``n_threads`` updates, every thread of the
round reading that stale w̄, and each update is

    α_i ← Π(α_i − γ·∇_i D(α) / Q_ii),   γ = 1/2 by default.

w̄ is a plain matrix product (``torch.matmul``, as the reference computes
it outside any Pallas kernel); the rest of a round is the threads'
gradient, step and projection in a few batched torch ops.  An epoch's
permutation is drawn once, before its rounds (the reference's key chain:
``PRNGKey(seed)``, per epoch ``key, sub = split(key)`` and
``permutation(sub, n)`` cut to whole rounds).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import prng
from repro_torch.core.objective import duality_gap
from repro_torch.data.sparse import EllMatrix
from repro_torch.dist.mesh import resolve_device


class AsyscdResult(NamedTuple):
    alpha: torch.Tensor
    gaps: torch.Tensor
    epochs: int


def _asyscd_epoch(X, sq_norms, alpha, rounds_idx, loss, gamma: float):
    """One epoch's rounds, in order: per round w̄ = Xᵀα, the round's
    gradients against that w̄, and the projected steps written back."""
    for idx in rounds_idx:
        w_bar = X.T @ alpha  # no primal maintenance: O(nnz) a round
        a = alpha[idx]
        grad = loss.dual_grad(a, X[idx] @ w_bar)
        step = gamma * grad / torch.clamp(sq_norms[idx], min=1e-12)
        alpha = alpha.index_copy(0, idx, loss.feasible(a - step))
    return alpha


def asyscd_solve(X, loss, *, n_threads: int = 4, epochs: int = 20,
                 gamma: float = 0.5, seed: int = 0, record: bool = True,
                 device=None) -> AsyscdResult:
    """AsySCD on a dense (n, d) X: ``epochs`` epochs of n // n_threads
    rounds, each round ``n_threads`` disjoint coordinates of the epoch's
    permutation against one stale w̄ = Xᵀα; the duality gap after every
    epoch with ``record``."""
    dev = resolve_device(device)
    if isinstance(X, EllMatrix):
        raise TypeError("asyscd_solve takes a dense (n, d) X, as the "
                        "reference's does")
    X = torch.as_tensor(X, dtype=torch.float32, device=dev).contiguous()
    n = X.shape[0]
    sq_norms = torch.sum(X * X, dim=1)
    alpha = torch.zeros((n,), dtype=torch.float32, device=dev)
    key = prng.PRNGKey(seed, device=dev)
    rounds = n // n_threads
    gaps = []
    for _ in range(epochs):
        key, sub = prng.split(key)
        perm = prng.permutation(sub, n)[: rounds * n_threads]
        alpha = _asyscd_epoch(X, sq_norms, alpha,
                              perm.reshape(rounds, n_threads), loss, gamma)
        if record:
            gaps.append(duality_gap(alpha, X, loss))
    gaps = (torch.stack(gaps).cpu() if gaps
            else torch.zeros((0,), dtype=torch.float32))
    return AsyscdResult(alpha, gaps, epochs)
