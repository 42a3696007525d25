"""CoCoA (Jaggi et al., 2014) with β_K = 1 and DCD as the local solver —
the synchronized parallel-DCD competitor of the paper's §5 — and the
serial oracle of the pod solver, the counterpart of
``repro/core/cocoa.py``.

``cocoa_solve``: every outer round each of K fixed partitions runs H
local DCD updates from the *shared* w snapshot, touching only its own
duals, and the merge is

    w ← w + (1/K) Σ_k Δw_k ,   α_k ← α_k + (1/K) Δα_k .

A partition's local solve is serial DCD over its rows in a permuted order
cycled to H steps — the function B2 computes.  The partition is fixed for
the whole solve, so its rows are gathered once into K contiguous shards,
and an outer round is one launch of B2's shard grid (K CTAs, one a
partition, each against the snapshot w, returning its own Δw; its wide
variant where H > 1,024 ids).

``cocoa_pod_solve``: the pod solver on a ``(pod = P, data = 1)`` mesh
replayed serially — per epoch each pod runs one local epoch (its drawn
block sequence, the pod solver's own draw) on its contiguous rows from
the shared (α, w), α picks up 1/P of its pod's Δα, and w the pod-mean Δw
through a ``pod_delay_rounds``-deep FIFO.  The P pods' local epochs are
one launch of B1 (an ``EllMatrix``, kept sparse: the reference densifies
it, which is the same function) or B2 over a grid of P shards.

On the card the kernels run or the call fails; on the CPU their plain
versions run (``repro_torch.kernels``).  The key chains are the
reference's, bit-exact (``repro_torch.prng``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import prng
from repro_torch.core.objective import duality_gap, w_of_alpha
from repro_torch.data.sparse import EllMatrix
from repro_torch.dist.mesh import resolve_device
from repro_torch.kernels.dcd_block import dcd_indexed_shards
from repro_torch.kernels.dcd_ell import dcd_ell_shards


class CocoaResult(NamedTuple):
    alpha: torch.Tensor
    w: torch.Tensor
    gaps: torch.Tensor
    rounds: int


class CocoaPodResult(NamedTuple):
    """Result of ``cocoa_pod_solve``: ``gaps``/``eps`` follow the pod
    solver's record schedule (every ``gap_every`` epochs plus the final
    one); ``eps`` is ‖w(α) − ŵ‖ against the (possibly stale) merged ŵ.
    ``fifo`` and ``key`` are the segmented-replay carry (``flush=False``
    only): the live FIFO and key chain to hand the next segment."""

    alpha: torch.Tensor
    w: torch.Tensor
    gaps: torch.Tensor
    eps: torch.Tensor
    rounds: int
    fifo: tuple | None = None
    key: torch.Tensor | None = None


def _dense(X, dev):
    if isinstance(X, EllMatrix):
        raise TypeError("cocoa_solve takes a dense (n, d) X, as the "
                        "reference's does")
    return torch.as_tensor(X, dtype=torch.float32, device=dev).contiguous()


def cocoa_solve(X, loss, *, n_partitions: int = 4, outer_rounds: int = 20,
                local_steps: int | None = None, seed: int = 0,
                record: bool = True, device=None) -> CocoaResult:
    """CoCoA on a dense (n, d) X: ``n_partitions`` K fixed partitions of
    n_k = n // K rows (``permutation(kpart, n)``, the n mod K rows left
    over never update), ``outer_rounds`` merges, ``local_steps`` H local
    updates a round (default n_k: one local epoch).  Each round draws K
    local orders (``split(sub, K)``, a permutation of n_k each, cycled
    to H steps) and runs them as one launch of B2 over K shards.  The
    gap is recorded after every round; the returned w is w(α)."""
    dev = resolve_device(device)
    X = _dense(X, dev)
    n, d = X.shape
    K = int(n_partitions)
    n_k = n // K
    key = prng.PRNGKey(seed, device=dev)
    key, kpart = prng.split(key)
    part = prng.permutation(kpart, n)[: n_k * K]
    H = n_k if local_steps is None else int(local_steps)
    Xp = X[part].contiguous()  # partition k's rows at [k·n_k, (k+1)·n_k)
    sq = torch.sum(Xp * Xp, dim=1)
    alpha = torch.zeros((n,), dtype=torch.float32, device=dev)
    w = torch.zeros((d,), dtype=torch.float32, device=dev)
    steps = torch.arange(H, device=dev) % max(n_k, 1)
    gaps = []
    for _ in range(outer_rounds):
        key, sub = prng.split(key)
        local = prng.permutation(prng.split(sub, K), n_k)  # (K, n_k)
        ids = local[:, steps].to(torch.int32).contiguous()
        a_part = alpha[part]
        a_new, dw = dcd_indexed_shards(Xp, a_part, w, sq, loss=loss, idx=ids,
                                       n_loc=n_k)
        scale = 1.0 / K  # β_K = 1
        w = w + scale * dw.sum(0)
        alpha = alpha.index_add(0, part, scale * (a_new - a_part))
        if record:
            gaps.append(duality_gap(alpha, X, loss))
    gaps = (torch.stack(gaps).cpu() if gaps
            else torch.zeros((0,), dtype=torch.float32))
    return CocoaResult(alpha, w_of_alpha(X, alpha), gaps, outer_rounds)


def _pod_rows(X, n_pod_loc: int, P: int):
    """X's rows padded to P·n_pod_loc (pod k's rows [k·n_pod_loc,
    (k+1)·n_pod_loc), the last pod's tail zero rows with q = 1), as the
    B1 or B2 operands, and the padded q."""
    n_pad = P * n_pod_loc
    if isinstance(X, EllMatrix):
        extra = n_pad - X.n_rows
        cols = X.indices.to(torch.int32)
        vals = X.values.to(torch.float32)
        sq = torch.sum(vals * vals, dim=1)
        if extra:
            cols = torch.cat([cols, torch.full((extra, X.k_max), X.n_features,
                                               dtype=torch.int32,
                                               device=cols.device)])
            vals = torch.cat([vals, vals.new_zeros((extra, X.k_max))])
            sq = torch.cat([sq, sq.new_ones((extra,))])
        return (cols.contiguous(), vals.contiguous()), sq
    extra = n_pad - X.shape[0]
    sq = torch.sum(X * X, dim=1)
    if extra:
        X = torch.cat([X, X.new_zeros((extra, X.shape[1]))])
        sq = torch.cat([sq, sq.new_ones((extra,))])
    return (X.contiguous(),), sq


def cocoa_pod_solve(X, loss, *, n_pods: int = 2, epochs: int = 10,
                    block_size: int = 64, pod_delay_rounds: int = 0,
                    seed: int = 0, record: bool = True, gap_every: int = 1,
                    alpha0=None, w0=None, epoch_start: int = 0,
                    total_epochs: int | None = None, key0=None, fifo0=None,
                    flush: bool = True, device=None) -> CocoaPodResult:
    """The serial oracle of the pod solver (``sharded_passcode_solve`` on
    a ``(pod = n_pods, data = 1)`` mesh): per epoch each pod runs one
    local epoch — its rows ``_device_block_perm_v`` of fleet index k of
    P keys, the pod solver's draw, run serially with locally fresh w —
    from the shared (α, w); α picks up 1/P of its own pod's Δα and w the
    pod-mean Δw through a ``pod_delay_rounds``-deep FIFO, flushed after
    the last epoch.  ``pod_delay_rounds=0`` is a synchronous CoCoA outer
    round over contiguous partitions.  The P local epochs are one launch
    of B1 (``EllMatrix``) or B2 (dense) over P shards; a pod that owns
    only padding takes no update (the reference's δ = 0).

    Segmented replay: ``epoch_start``/``total_epochs`` run the slice
    [epoch_start, epoch_start + epochs) of a ``total_epochs`` solve — the
    record schedule keys on the global epoch, and the key chain
    fast-forwards ``epoch_start`` splits unless ``key0`` is given.
    ``flush=False`` returns the live FIFO and key instead of flushing, so
    the next segment (fed ``alpha0``/``w0``/``fifo0``/``key0``) continues
    it bit for bit."""
    from repro_torch.core.sharded import _device_block_perm_v, _n_blocks

    dev = resolve_device(device)
    ell = isinstance(X, EllMatrix)
    X = X.to(dev) if ell else _dense(X, dev)
    n, d = (X.n_rows, X.n_features) if ell else X.shape
    P = int(n_pods)
    if P < 1:
        raise ValueError(f"n_pods must be >= 1, got {P}")
    delay = int(pod_delay_rounds)
    if delay < 0:
        raise ValueError(f"pod_delay_rounds must be >= 0, got {delay}")
    n_pod_loc = max(-(-n // P), 1)
    n_blocks = _n_blocks(n_pod_loc, block_size)
    rows, sq = _pod_rows(X, n_pod_loc, P)
    scale = 1.0 / P
    gap_every = max(int(gap_every), 1)
    e0 = int(epoch_start)
    total = int(total_epochs) if total_epochs is not None else e0 + epochs
    f32 = dict(dtype=torch.float32, device=dev)
    alpha = (torch.zeros((n,), **f32) if alpha0 is None
             else torch.as_tensor(alpha0, **f32).reshape(-1).clone())
    w = (torch.zeros((d,), **f32) if w0 is None
         else torch.as_tensor(w0, **f32).reshape(-1).clone())
    if fifo0 is not None:
        fifo = [torch.as_tensor(g, **f32) for g in fifo0]
        if len(fifo) != delay:
            raise ValueError(
                f"fifo0 has depth {len(fifo)}, expected {delay}")
    else:
        fifo = [torch.zeros((d,), **f32) for _ in range(delay)]
    if key0 is not None:
        key = torch.as_tensor(key0, dtype=torch.int64, device=dev)
    else:
        key = prng.PRNGKey(seed, device=dev)
        for _ in range(e0):  # fast-forward the chain to epoch_start
            key, _ = prng.split(key)
    real = [max(n - k * n_pod_loc, 0) for k in range(P)]
    live = torch.tensor([c > 0 for c in real], device=dev)
    n_pad = P * n_pod_loc
    gaps, eps = [], []
    for e in range(e0, e0 + epochs):
        key, sub = prng.split(key)
        ids = torch.stack([
            _device_block_perm_v(sub, k, P, n_pod_loc,
                                 min(max(real[k], 1), n_pod_loc), n_blocks,
                                 block_size).reshape(-1)
            for k in range(P)])
        a_pad = torch.cat([alpha, alpha.new_zeros((n_pad - n,))])
        if ell:
            a1, dw = dcd_ell_shards(*rows, a_pad, torch.cat([w, w.new_zeros(1)]),
                                    sq, loss=loss, idx=ids,
                                    n_loc=n_pod_loc)
            dw = dw[:, :d]
        else:
            a1, dw = dcd_indexed_shards(*rows, a_pad, w, sq, loss=loss,
                                        idx=ids, n_loc=n_pod_loc)
        # a pod of padding only moves nothing (its draw's δ is 0)
        dw = torch.where(live[:, None], dw, 0.0)
        g = dw[0]
        for k in range(1, P):  # the pods' Δw in pod order
            g = g + dw[k]
        alpha = alpha + scale * (a1[:n] - alpha)
        g = scale * g
        if delay == 0:
            w = w + g
        else:
            w = w + fifo.pop(0)
            fifo.append(g)
        if record and ((e + 1) % gap_every == 0 or e == total - 1):
            gaps.append(duality_gap(alpha, X, loss))
            eps.append(torch.linalg.vector_norm(w_of_alpha(X, alpha) - w))
    gaps = (torch.stack(gaps).cpu() if gaps
            else torch.zeros((0,), dtype=torch.float32))
    eps = (torch.stack(eps).cpu() if eps
           else torch.zeros((0,), dtype=torch.float32))
    if not flush:
        return CocoaPodResult(alpha, w, gaps, eps, epochs, fifo=tuple(fifo),
                              key=key)
    for g_in in fifo:
        w = w + g_in  # flush the in-flight merges
    return CocoaPodResult(alpha, w, gaps, eps, epochs)
