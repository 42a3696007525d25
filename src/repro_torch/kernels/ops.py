"""Entry points of the DCD kernels with the reference's shape contract —
the counterpart of ``repro/kernels/ops.py``.

``dcd_epoch`` is the standalone epoch (B3 in row order, B2 in ``idx``
order); ``dcd_block_update`` and ``dcd_ell_block_update`` are the block
engines the 1-D solver runs once per round, returning (α, Δw) like the
reference's ``dcd_block_update_pallas`` / ``dcd_ell_block_update_pallas``.

The 2-D (feature-sharded) round is split in phases as in the
reference: ``dcd_feature_gram`` (B4 over all m shards, then the sum over
shards — the reference's psum over ``model``), ``dcd_feature_base_
correction`` (torch ops) and ``dcd_feature_update`` (B5);
``dcd_feature_block_update`` composes them eagerly and returns (α, Δw).

Each runs its kernel on CUDA tensors and the kernel's plain version on
CPU tensors.  Each block engine also takes the multi-task solver's K
tasks as a leading dimension (a (K, n) α; B4's phase ``tasks=True``):
K × p pairs in one launch, each with its own α, w, labels and mask on
the shared X; and the pod solver's P pods (a w of P views for p shards,
1 < P < p): the p shards are P pods' (shard s of pod s // (p / P)),
each pod's shards reading the pod's own view of w, one launch for the
whole fleet.
"""

from __future__ import annotations

import torch

from repro_torch.core.duals import Hinge, SquaredHinge
from repro_torch.data.sparse import flat_shard_ids
from repro_torch.kernels import dcd_feature as feat
from repro_torch.kernels.dcd_block import (
    dcd_indexed_epoch,
    dcd_indexed_shards,
    dcd_tile_epoch,
)
from repro_torch.kernels.dcd_ell import dcd_ell_shards


def dcd_epoch(X, alpha, w, sq_norms=None, *, c: float = 1.0,
              sq_hinge: bool = False, loss=None, idx=None,
              block_rows: int = 256):
    """One DCD epoch — in row order (B3), or in ``idx`` order (B2) when a
    row-index vector is given; out-of-order and repeated ids are allowed.

    In row order B3 runs on X as given: the CUDA kernel needs no block
    multiple, and the reference's padding rows (all zero, after the
    last real row) change neither w nor any real α.

    In ``idx`` order the padding contract of
    ``repro.kernels.ops.dcd_epoch_pallas`` is kept, because there the
    padded slots are updates of their own: ``idx`` is padded to a
    multiple of ``block_rows`` with slots that point at one extra zero
    row n carrying α = 0 and q = 1.  A zero row cannot change w (its wᵀx
    is 0 and its rank-1 update is identically 0); q = 1 keeps its δ
    finite; its α entry takes junk and is sliced off, so the returned
    (α[:n], w) are exactly the unpadded sequence's result.  The
    reference's 128-lane padding of d is TPU tiling and is not kept.

    ``loss`` overrides the legacy ``c``/``sq_hinge`` flags.
    """
    if loss is None:
        loss = (SquaredHinge if sq_hinge else Hinge)(C=c)
    n, d = X.shape
    dev = X.device
    f32 = torch.float32
    if sq_norms is None:
        sq_norms = torch.sum(X * X, dim=1)
    wp = w.to(f32).contiguous()
    if idx is None:
        return dcd_tile_epoch(X.to(f32).contiguous(),
                              alpha.to(f32).contiguous(), wp,
                              sq_norms.to(f32).contiguous(), loss=loss)
    idx = torch.as_tensor(idx, dtype=torch.int32, device=dev)
    if idx.numel() and not (0 <= int(idx.min()) and int(idx.max()) < n):
        raise ValueError(f"idx must hold row ids in [0, {n})")
    m = idx.shape[0]
    br = min(block_rows, max(1, m))
    m_pad = -(-m // br) * br
    n_pad = n + 1 if m_pad > m else n
    idx = torch.cat([idx, torch.full((m_pad - m,), n, dtype=torch.int32,
                                     device=dev)])
    Xp = torch.zeros((n_pad, d), dtype=f32, device=dev)
    Xp[:n] = X
    ap = torch.zeros((n_pad,), dtype=f32, device=dev)
    ap[:n] = alpha
    qp = torch.ones((n_pad,), dtype=f32, device=dev)
    qp[:n] = sq_norms
    a_out, w_out = dcd_indexed_epoch(Xp, ap, wp, qp, loss=loss, idx=idx)
    return a_out[:n], w_out


def dcd_block_update(X, sq_norms, alpha, w, idx, *, loss, active=None,
                     y=None, n_loc: int = 0):
    """One indexed block of sequential DCD updates on a dense shard (B2).
    Returns (updated α shard, local Δw = w_new − w), the reference's
    round trip.  A (p, B) ``idx`` is p data shards, shard s's ids local
    to rows [s·n_loc, (s+1)·n_loc), each against ``w`` (or its own row
    of a (p, d) ``w``): returns (α, Δw (p, d)), the shards' Δw before
    their sum.  Either way it is one launch of the shard grid (a (B,)
    ``idx`` is a grid of one shard).  A (K, n) α is K tasks
    (``dcd_indexed_shards``): (α (K, n), Δw (K, p, d)).  A (P, d) (or
    (K, P, d)) ``w`` for 1 < P < p is a view a pod."""
    if idx.dim() == 1:
        a_new, dw = dcd_indexed_shards(X, alpha, w, sq_norms, loss=loss,
                                       idx=idx[None], n_loc=0,
                                       active=active, y=y)
        return a_new, dw[0]
    return dcd_indexed_shards(X, alpha, w, sq_norms, loss=loss, idx=idx,
                              n_loc=n_loc, active=active, y=y)


def dcd_ell_block_update(cols, vals, sq_norms, alpha, w_pad, idx, *, loss,
                         active=None, y=None, n_loc: int = 0):
    """One indexed block of sequential DCD updates on an ELL shard (B1)
    against the (d+1,) padded primal.  Returns (updated α shard, local
    Δw_pad); the dummy slot of Δw_pad is identically zero.  A (p, B)
    ``idx`` is p data shards as in ``dcd_block_update``: (α, Δw
    (p, d+1)); a (K, n) α K tasks: (α (K, n), Δw (K, p, d+1)); a
    (P, d+1) (or (K, P, d+1)) ``w_pad`` for 1 < P < p a view a pod."""
    if idx.dim() == 1:
        a_new, dw = dcd_ell_shards(cols, vals, alpha, w_pad, sq_norms,
                                   loss=loss, idx=idx[None], n_loc=0,
                                   active=active, y=y)
        return a_new, dw[0]
    return dcd_ell_shards(cols, vals, alpha, w_pad, sq_norms, loss=loss,
                          idx=idx, n_loc=n_loc, active=active, y=y)


# ------------------- split-phase 2-D (feature-sharded) block entry points
# cols/vals: (n, m, k) shard-local ELL slices, w: (m, d_loc + 1) primal
# slices; see repro_torch.kernels.dcd_feature.  A (p, B) ``idx`` is p data
# shards, shard s's ids local to its rows [s·n_loc, (s+1)·n_loc), each
# with its own (base, Gram) and its own replica of w.  ``tasks`` (a (K, n)
# α for the update phases) puts K tasks in front: w (K, m, d_loc + 1) or
# (K, p, m, d_loc + 1), idx (p, B) or (K, p, B), and a leading K on every
# result.  A w of P views for 1 < P < p, (P, m, d_loc + 1) or
# (K, P, m, d_loc + 1), makes the p data shards P pods', a view a pod.
# Where the m feature shards are spread over ranks, cols/vals/w hold this
# rank's: ``gather`` (the solver's psum over ``model``) takes each
# partial to all m shards before the sum — ``gather(t, dim)`` for a
# partial already reduced, ``gather.dots(prod)`` for the shards' Σ_k of
# a (…, m, k) product — and B4's workspace records the mesh's m, so B4
# and B5 lay out their launches as the one-process launch does.


def dcd_feature_gram(cols, vals, w_ref, idx, *, workspace=None,
                     n_loc: int = 0, tasks: bool = False, gather=None):
    """Phase 1: the block's (base, Gram) — B4's per-shard partials summed
    over the shard dimension, the reference's psum over ``model``.
    ``base`` is w_refᵀx_t against whatever reference primal the caller
    holds (one data-round stale in the overlapped round, repaired by
    ``dcd_feature_base_correction``).  Returns (base (B,), gram (B, B)),
    or (p, B) and (p, B, B) for p data shards ((K, p, B) and (K, p, B, B)
    with ``tasks``)."""
    base_p, gram_p = feat.dcd_feature_gram(cols, vals, w_ref, idx,
                                           workspace=workspace, n_loc=n_loc,
                                           tasks=tasks)
    if gather is not None:
        base_p, gram_p = gather(base_p, -2), gather(gram_p, -3)
    return base_p.sum(-2), gram_p.sum(-3)


def dcd_feature_base_correction(cols, vals, dvec, idx, n_loc: int = 0,
                                tasks: bool = False, gather=None):
    """Correct a stale base by the aggregate it was computed without:
    Δbase_t = Δwᵀx_t for the block's rows, each shard's partial summed
    over shards.  ``dvec`` is the (m, d_loc + 1) missing aggregate; a
    (p, B) ``idx`` gives each data shard's (p, B).  With ``tasks`` each
    task's (m, d_loc + 1) aggregate of a (K, m, d_loc + 1) ``dvec``
    against its ids (idx (p, B) or (K, p, B)): (K, p, B)."""
    if tasks:
        return torch.stack([
            dcd_feature_base_correction(cols, vals, dvec[t],
                                        idx[t] if idx.dim() == 3 else idx,
                                        n_loc, gather=gather)
            for t in range(dvec.shape[0])])
    rows = idx.long()
    if idx.dim() == 2:
        rows = rows + n_loc * torch.arange(idx.shape[0],
                                           device=idx.device)[:, None]
    ids = flat_shard_ids(cols[rows], dvec.shape[-1])  # (..., B, m, k)
    prod = dvec.reshape(-1)[ids] * vals[rows]
    part = torch.sum(prod, dim=-1) if gather is None else gather.dots(prod)
    return part.sum(-1)


def dcd_feature_update(cols, vals, sq_norms, alpha, w, idx, base, gram, *,
                       loss, active=None, y=None, workspace=None,
                       n_loc: int = 0):
    """Phase 2: the B-step δ recursion against a summed (base, Gram) —
    B5.  ``sq_norms`` are the full row norms; ``workspace``, if given,
    holds B4's buckets of this same block.  Returns (updated α, updated
    primal slices) — for p data shards, each shard's updated replica
    (p, m, d_loc + 1); for a (K, n) α, (K, p, m, d_loc + 1)."""
    return feat.dcd_feature_update(cols, vals, alpha, sq_norms, w, idx,
                                   base, gram, loss=loss, active=active,
                                   y=y, workspace=workspace, n_loc=n_loc)


def dcd_feature_block_update(cols, vals, sq_norms, alpha, w, idx, *, loss,
                             active=None, y=None, workspace=None,
                             n_loc: int = 0, gather=None):
    """One indexed block of B sequential updates on the feature
    shards — the fused counterpart of the solver's unfused engine, the
    eager composition of the phases above.  Returns (updated α, Δw =
    w_new − w over the (m, d_loc + 1) slices), or the p data shards' Δw
    (p, m, d_loc + 1); for a (K, n) α, each task's (K, p, m, d_loc + 1).
    With a view a pod each data shard's Δw is against its pod's view."""
    tasks = alpha.dim() == 2
    base, gram = dcd_feature_gram(cols, vals, w, idx, workspace=workspace,
                                  n_loc=n_loc, tasks=tasks, gather=gather)
    a_new, w_new = dcd_feature_update(cols, vals, sq_norms, alpha, w, idx,
                                      base, gram, loss=loss, active=active,
                                      y=y, workspace=workspace, n_loc=n_loc)
    if tasks and w.dim() == 3:
        w = w[:, None]  # one w for every data shard of a task
    if w.dim() == w_new.dim() >= 3 and 1 < w.shape[-3] < w_new.shape[-3]:
        # a view a pod against its shards' replicas
        dw = w_new.unflatten(-3, (w.shape[-3], -1)) - w.unsqueeze(-3)
        return a_new, dw.flatten(-4, -3)
    return a_new, w_new - w
