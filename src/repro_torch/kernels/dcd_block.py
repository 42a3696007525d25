"""B2 and B3: DCD over a dense row shard — the CUDA kernels
``csrc/dcd_block.cu`` and their plain PyTorch versions.

* B2, ``dcd_indexed_epoch``, replaces the Pallas TPU kernel
  ``repro/kernels/dcd_block.py:_dcd_indexed_kernel``: the updates of an
  arbitrary id sequence ``idx`` (repeats and any order allowed) with an
  optional ``active`` 0/1 mask (frozen rows take δ = 0 exactly) and
  optional ±1 ``y`` folded on read (wx = y_i·w·x_i, w += δ·y_i·x_i).
* B3, ``dcd_tile_epoch``, replaces ``_dcd_tile_kernel``: one in-order
  epoch over rows 0..n-1, no mask and no labels.

Each has two variants, picked by shape.  B2 (``repro_torch.dist.mesh.
dcd_dense_plan``): "staged", the block's rows in shared memory and w in
the registers of one warp (covtype's 64 ids of 54 floats), and "wide",
rows and w in device memory (wider rows, or blocks too large to stage).
B3 (``dcd_tile_plan``): "stream", the rows streamed in order through a
ring of stages in shared memory by a producer warp while a consumer warp
holds w in registers (rows of at most 256 floats, such as covtype's),
and "wide", B2's wide kernel over rows 0..n-1.

``dcd_indexed_shards`` runs B2 over the sharded solver's round: p data
shards, each its own block of ids against w, as one launch of p CTAs,
returning each shard's Δw (the reference's per-device Δw before the psum
over ``data``); with a (K, n) α, K tasks of p shards each, as one
launch of K × p CTAs (the multi-task solver's round).

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back from one to the other.
α and w are float32; X is float32, (n, d), any d.
"""

from __future__ import annotations

import torch

from repro_torch.core.duals import kernel_params
from repro_torch.dist.mesh import dcd_dense_plan, dcd_tile_plan
from repro_torch.kernels import build
from repro_torch.kernels.build import F, I, L, P
from repro_torch.kernels.dcd_ell import task_grid, task_loop


def dcd_indexed_epoch_plain(X, alpha, w, sq_norms, *, loss, idx,
                            active=None, y=None):
    """The plain version of B2: one update at a time in torch ops, the
    reference's order.  Returns new (α, w); the inputs are not changed."""
    alpha, w = alpha.clone(), w.clone()
    for i in idx.tolist():
        x = X[i]
        wx = torch.dot(w, x)
        if y is not None:
            wx = y[i] * wx
        delta = loss.delta(alpha[i], wx, sq_norms[i])
        if active is not None:
            delta = torch.where(active[i] > 0.0, delta, 0.0)
        alpha[i] = alpha[i] + delta
        w = w + (delta if y is None else delta * y[i]) * x
    return alpha, w


def dcd_tile_epoch_plain(X, alpha, w, sq_norms, *, loss):
    """The plain version of B3: B2's plain version over rows in order."""
    idx = torch.arange(X.shape[0], dtype=torch.int32)
    return dcd_indexed_epoch_plain(X, alpha, w, sq_norms, loss=loss, idx=idx)


def _check(X, alpha, w, sq_norms, idx=None, active=None, y=None):
    n, d = X.shape
    if idx is not None and idx.dim() != 1:
        raise ValueError("idx must be 1-D")
    build.check_operands(alpha.device, {
        "X": (X, None), "alpha": (alpha, (n,)), "w": (w, (d,)),
        "sq_norms": (sq_norms, (n,)), "active": (active, (n,)),
        "y": (y, (n,)), "idx": (idx, None)}, int32=("idx",))


def _indexed_launch(plan, idx, m, n_loc, X, alpha, w, sq_norms, active, y,
                    loss, w_stride=0, dw=None, strides=(0, 0, 0, 0)):
    """Launch B2's kernel for ``plan`` on operands already checked:
    ``plan.shards`` × ``plan.tasks`` CTAs of ``m`` ids each.  The staged
    kernel writes the (task, shard) pairs' Δw slices into ``dw`` (or,
    with one pair and no ``dw``, updates ``w`` in place); the wide
    kernel updates ``w`` in place, a replica a pair.  ``strides`` are
    the task strides of the ids, of α and y, of act and of w (words)."""
    idx_ts, row_ts, act_ts, w_ts = strides
    args = [build.ptr(idx), m, plan.shards, n_loc, build.ptr(X), X.shape[1],
            build.ptr(alpha), build.ptr(sq_norms), build.ptr(active),
            build.ptr(y), build.ptr(w)]
    types = [P, I, I, L, P, I, P, P, P, P, P]
    if plan.variant == "staged":
        fn = "dcd_block_staged_launch"
        types += [L, P, I, F, F, F, I, I, I, I, I, L, L, L, L, P]
        args += [w_stride, build.ptr(dw), *kernel_params(loss),
                 plan.per_lane, plan.threads, plan.smem_bytes, plan.tasks,
                 idx_ts, row_ts, act_ts, w_ts]
    else:
        fn = "dcd_block_indexed_launch"
        types += [I, F, F, F, I, I, I, L, L, L, P]
        args += [*kernel_params(loss), plan.threads, plan.tasks, idx_ts,
                 row_ts, act_ts]
    launch = build.entry("dcd_block", fn, types)
    with torch.cuda.device(alpha.device):
        err = launch(*args, build.stream())
    build.check(err, fn)


def dcd_indexed_epoch(X, alpha, w, sq_norms, *, loss, idx, active=None,
                      y=None, wide=False):
    """B2: run the updates of ``idx`` (int32) and return new (α, w).
    CUDA tensors launch a kernel (one CTA; every launch counts in
    ``dcd_indexed_epoch.launches``, and in
    ``dcd_indexed_epoch.variant_launches`` under its variant); CPU
    tensors run the plain version.  ``wide=True`` launches the wide
    variant whatever the shape, to hold the two against each other.  The
    ids must lie in [0, n); as for B1, the callers check them where they
    come from outside."""
    if alpha.device.type != "cuda":
        return dcd_indexed_epoch_plain(X, alpha, w, sq_norms, loss=loss,
                                       idx=idx, active=active, y=y)
    _check(X, alpha, w, sq_norms, idx, active, y)
    a_out, w_out = alpha.clone(), w.clone()
    m = idx.shape[0]
    if m == 0:
        return a_out, w_out
    plan = dcd_dense_plan(m, X.shape[1], wide)
    _indexed_launch(plan, idx, m, 0, X, a_out, w_out, sq_norms, active, y,
                    loss)
    dcd_indexed_epoch.launches += 1
    dcd_indexed_epoch.variant_launches[plan.variant] += 1
    return a_out, w_out


def dcd_indexed_shards_plain(X, alpha, w_eff, sq_norms, *, loss, idx, n_loc,
                             active=None, y=None):
    """The plain version of B2 over a grid of p data shards: shard s, in
    shard order, runs its ids ``idx[s]`` (rows s·n_loc + id) against
    ``w_eff`` (or ``w_eff[s]`` when it is (p, d)), as
    ``dcd_indexed_epoch_plain`` does.  Returns (α, Δw (p, d)).  A (K, n)
    α is K tasks (``dcd_ell.task_grid``), run in task order: (α (K, n),
    Δw (K, p, d))."""
    if alpha.dim() == 2:
        return task_loop(dcd_indexed_shards_plain, (X,), alpha, w_eff,
                         sq_norms, loss, idx, n_loc, active, y)
    dws = []
    for s in range(idx.shape[0]):
        w_s = w_eff[s] if w_eff.dim() == 2 else w_eff
        alpha, w_new = dcd_indexed_epoch_plain(
            X, alpha, w_s, sq_norms, loss=loss,
            idx=idx[s].long() + s * n_loc, active=active, y=y)
        dws.append(w_new - w_s)
    return alpha, torch.stack(dws)


def dcd_indexed_shards(X, alpha, w_eff, sq_norms, *, loss, idx, n_loc,
                       active=None, y=None, wide=False):
    """B2 over a grid of p data shards: ``idx`` (p, B) int32 shard-local
    ids, shard s owning rows [s·n_loc, (s+1)·n_loc) of X; ``w_eff`` the
    (d,) primal every shard reads, or (p, d), one a shard.  Returns (α,
    Δw (p, d)), which the caller sums in shard order.  With a (K, n) α
    the grid has a task dimension (``dcd_ell.task_grid``: w_eff (K, d)
    or (K, p, d), idx (p, B) or (K, p, B), y (K, n), active (n,) or
    (K, n)) and returns (α (K, n), Δw (K, p, d)).  CUDA tensors launch
    one kernel of K × p CTAs (counted in ``dcd_indexed_shards.launches``,
    under its variant, and in ``dcd_indexed_shards.task_launches`` when
    K > 1): the staged kernel writes each pair's d-word Δw slice, the
    wide one updates a replica of w a pair (Δw = replica − w_eff).  CPU
    tensors run ``dcd_indexed_shards_plain``."""
    if alpha.device.type != "cuda":
        return dcd_indexed_shards_plain(X, alpha, w_eff, sq_norms, loss=loss,
                                        idx=idx, n_loc=n_loc, active=active,
                                        y=y)
    tasks = alpha.dim() == 2
    idx, w_eff = idx.contiguous(), w_eff.contiguous()
    K, idx_ts, row_ts, act_ts = task_grid(alpha, idx, active, y)
    p, m = idx.shape[-2:]
    n, d = X.shape
    W = w_eff if tasks else w_eff[None]  # (K, d) or (K, p, d)
    if W.dim() not in (2, 3) or W.shape[0] != K or W.shape[-1] != d or (
            W.dim() == 3 and W.shape[1] != p):
        raise ValueError(f"w_eff must be (d,) or ({p}, d), a task each")
    build.check_operands(alpha.device, {
        "X": (X, None), "alpha": (alpha, (*alpha.shape[:-1], n)),
        "w_eff": (W, None), "sq_norms": (sq_norms, (n,)),
        "active": (active, None), "y": (y, None), "idx": (idx, None)},
        int32=("idx",))
    a_out = alpha.clone()
    lead = (K,) if tasks else ()
    if m == 0:
        return a_out, torch.zeros((*lead, p, d), dtype=torch.float32,
                                  device=alpha.device)
    plan = dcd_dense_plan(m, d, wide, p, K)
    if plan.variant == "staged":
        dw = torch.empty((*lead, p, d), dtype=torch.float32,
                         device=alpha.device)
        _indexed_launch(plan, idx, m, n_loc, X, a_out, W, sq_norms,
                        active, y, loss,
                        w_stride=d if W.dim() == 3 else 0, dw=dw,
                        strides=(idx_ts, row_ts, act_ts, W[0].numel()))
    else:
        Wp = W if W.dim() == 3 else W[:, None]
        rep = Wp.expand(K, p, d).clone(memory_format=torch.contiguous_format)
        _indexed_launch(plan, idx, m, n_loc, X, a_out, rep, sq_norms,
                        active, y, loss, strides=(idx_ts, row_ts, act_ts, 0))
        dw = (rep - Wp).view(*lead, p, d)
    dcd_indexed_shards.launches += 1
    dcd_indexed_shards.variant_launches[plan.variant] += 1
    dcd_indexed_shards.task_launches += int(K > 1)
    return a_out, dw


def dcd_tile_epoch(X, alpha, w, sq_norms, *, loss, wide=False):
    """B3: one in-order epoch over the rows of X; returns new (α, w).
    CUDA tensors launch a kernel (one CTA; every launch counts in
    ``dcd_tile_epoch.launches``, and in ``dcd_tile_epoch.variant_launches``
    under its variant); CPU tensors run the plain version.  ``wide=True``
    launches the wide variant whatever the shape, to hold the two against
    each other.  X and ``sq_norms`` may be views at any offset (a stage
    whose source is not 16-byte aligned is copied in 4-byte units)."""
    if alpha.device.type != "cuda":
        return dcd_tile_epoch_plain(X, alpha, w, sq_norms, loss=loss)
    _check(X, alpha, w, sq_norms)
    a_out, w_out = alpha.clone(), w.clone()
    n, d = X.shape
    if n == 0:
        return a_out, w_out
    plan = dcd_tile_plan(n, d, wide)
    tile_launch(plan, X, a_out, w_out, sq_norms, loss)
    dcd_tile_epoch.launches += 1
    dcd_tile_epoch.variant_launches[plan.variant] += 1
    return a_out, w_out


def tile_launch(plan, X, alpha, w, sq_norms, loss):
    """Launch B3's kernel for ``plan`` (a ``repro_torch.dist.mesh.
    TilePlan``) on CUDA tensors already checked, updating ``alpha`` and
    ``w`` in place; counts nothing.  ``dcd_tile_epoch`` calls it with the
    plan for the shape; a measurement may pass another layout."""
    n, d = X.shape
    args = [n, build.ptr(X), d, build.ptr(alpha), build.ptr(sq_norms),
            build.ptr(w), *kernel_params(loss)]
    types = [I, P, I, P, P, P, I, F, F, F, I]
    if plan.variant == "stream":
        fn = "dcd_block_tile_stream_launch"
        types += [I, I, I, I, P]
        args += [plan.per_lane, plan.tile_rows, plan.stages,
                 plan.smem_bytes]
    else:
        fn = "dcd_block_tile_launch"
        types += [I, P]
        args += [plan.threads]
    launch = build.entry("dcd_block", fn, types)
    with torch.cuda.device(alpha.device):
        err = launch(*args, build.stream())
    build.check(err, fn)


dcd_indexed_epoch.launches = 0
dcd_indexed_epoch.variant_launches = {"staged": 0, "wide": 0}
dcd_indexed_shards.launches = 0
dcd_indexed_shards.variant_launches = {"staged": 0, "wide": 0}
dcd_indexed_shards.task_launches = 0
dcd_tile_epoch.launches = 0
dcd_tile_epoch.variant_launches = {"stream": 0, "wide": 0}
