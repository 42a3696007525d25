"""B1: indexed DCD over an ELL row shard — the CUDA kernel
``csrc/dcd_ell.cu`` (replacing the Pallas TPU kernel
``repro/kernels/dcd_ell.py:_dcd_ell_indexed_kernel``) and its plain
PyTorch version.

The shard is the ELL layout of ``repro_torch.data.sparse.EllMatrix``:

  cols: (n, k) int32 column ids, padding == d (the dummy slot)
  vals: (n, k) float32 values, padding == 0.0

against a (d+1,) padded primal whose slot d is the dummy slot.  For
each id i of ``idx``, in order: wx = y_i·Σ w[cols_i]·vals_i,
δ = loss.delta(α_i, wx, q_i) (0 where ``active`` is 0), α_i += δ,
w[cols_i] += δ·y_i·vals_i.  ``dcd_ell_epoch`` launches a kernel for
CUDA tensors and runs ``dcd_ell_epoch_plain`` for CPU tensors; it never
falls back from one to the other.  The kernel has two variants, picked
by shape (``repro_torch.dist.mesh.dcd_ell_plan``): "staged", the block's
rows and columns of w in shared memory (a block of 64 rcv1 rows), and
"wide", rows and w in device memory (rows too long to stage, such as
webspam's).  No lane padding: k and d are taken as they are.

``dcd_ell_shards`` runs the sharded solver's round: p data shards, each
its own block of ids against w, as one launch of p CTAs, returning each
shard's Δw (the reference's per-device Δw before the psum over
``data``); with a (K, n) α, K tasks of the multi-task solver, each its
own α, w, labels and mask on the shared rows, as one launch of K × p
CTAs (``task_grid`` lays out the operands, ``task_loop`` runs a
shard-grid plain version task by task).
"""

from __future__ import annotations

import torch

from repro_torch.core.duals import kernel_params
from repro_torch.dist.mesh import dcd_ell_plan
from repro_torch.kernels import build
from repro_torch.kernels.build import F, I, L, P


def dcd_ell_epoch_plain(cols, vals, alpha, w_pad, sq_norms, *, loss, idx,
                        active=None, y=None):
    """The plain version: one update at a time in torch ops, the
    reference's order.  Returns new (α, w_pad); the inputs are not
    changed."""
    alpha, w = alpha.clone(), w_pad.clone()
    for i in idx.tolist():
        c = cols[i].long()
        v = vals[i]
        wx = torch.sum(w[c] * v)
        if y is not None:
            wx = y[i] * wx
        delta = loss.delta(alpha[i], wx, sq_norms[i])
        if active is not None:
            delta = torch.where(active[i] > 0.0, delta, 0.0)
        alpha[i] = alpha[i] + delta
        w.index_add_(0, c, (delta if y is None else delta * y[i]) * v)
    return alpha, w


def _check(cols, vals, alpha, w_pad, sq_norms, idx, active, y):
    n, k = cols.shape
    if w_pad.dim() != 1 or idx.dim() != 1:
        raise ValueError("expected w_pad (d+1,) and idx (m,)")
    build.check_operands(alpha.device, {
        "cols": (cols, None), "vals": (vals, (n, k)), "alpha": (alpha, (n,)),
        "sq_norms": (sq_norms, (n,)), "active": (active, (n,)),
        "y": (y, (n,)), "w_pad": (w_pad, None), "idx": (idx, None)},
        int32=("cols", "idx"))


def _check_grid(cols, vals, alpha, w, sq_norms, idx, active, y):
    """The operands of a shard-grid launch, their shapes already matched
    by ``task_grid``: contiguous, on α's device, of the kernel's type."""
    n, k = cols.shape
    build.check_operands(alpha.device, {
        "cols": (cols, None), "vals": (vals, (n, k)),
        "alpha": (alpha, (*alpha.shape[:-1], n)),
        "sq_norms": (sq_norms, (n,)),
        "active": (active, None), "y": (y, None), "w_eff": (w, None),
        "idx": (idx, None)}, int32=("cols", "idx"))


def _launch(plan, idx, m, n_loc, cols, vals, alpha, w, sq_norms, active, y,
            loss, w_stride=0, dw=None, strides=(0, 0, 0, 0)):
    """Launch B1's kernel for ``plan`` on operands already checked:
    ``plan.shards`` × ``plan.tasks`` CTAs of ``m`` ids each.  The staged
    kernel writes the (task, shard) pairs' Δw slices into ``dw`` (or,
    with one pair and no ``dw``, updates ``w`` in place); the wide kernel
    updates ``w`` in place, a replica a pair.  ``strides`` are the task
    strides of the ids, of α and y, of act and of w (words)."""
    k = cols.shape[1]
    d = (w.shape[-1] if dw is None else dw.shape[-1]) - 1
    idx_ts, row_ts, act_ts, w_ts = strides
    args = [build.ptr(idx), m, plan.shards, n_loc, build.ptr(cols),
            build.ptr(vals), k, d, build.ptr(alpha), build.ptr(sq_norms),
            build.ptr(active), build.ptr(y), build.ptr(w)]
    types = [P, I, I, L, P, P, I, I, P, P, P, P, P]
    if plan.variant == "staged":
        fn = "dcd_ell_staged_launch"
        types += [L, P, I, F, F, F, I, I, I, I, I, L, L, L, L]
        args += [w_stride, build.ptr(dw), *kernel_params(loss),
                 plan.table_slots, plan.threads, plan.smem_bytes,
                 plan.tasks, idx_ts, row_ts, act_ts, w_ts]
    else:
        fn = "dcd_ell_launch"
        types += [I, F, F, F, I, I, I, L, L, L]
        args += [*kernel_params(loss), plan.threads, plan.tasks, idx_ts,
                 row_ts, act_ts]
    launch = build.entry("dcd_ell", fn, types + [P])
    with torch.cuda.device(alpha.device):
        err = launch(*args, build.stream())
    build.check(err, fn)


def dcd_ell_epoch(cols, vals, alpha, w_pad, sq_norms, *, loss, idx,
                  active=None, y=None, wide=False):
    """Run the updates of ``idx`` (int32 row ids, any order, repeats
    allowed) and return new (α, w_pad).  CUDA tensors launch a B1 kernel
    (one CTA; every launch counts in ``dcd_ell_epoch.launches``, and in
    ``dcd_ell_epoch.variant_launches`` under its variant); CPU tensors
    run the plain version.  The ids must lie in [0, n): checking them
    here would sync with the card on every launch, so the callers check
    them where they come from outside (``ops.dcd_epoch``, the solvers'
    ``blocks=``/``perms=``).  Column ids outside [0, d) are skipped.
    ``wide=True`` launches the wide variant whatever the shape, to hold
    the two variants against each other on one block."""
    if alpha.device.type != "cuda":
        return dcd_ell_epoch_plain(cols, vals, alpha, w_pad, sq_norms,
                                   loss=loss, idx=idx, active=active, y=y)
    _check(cols, vals, alpha, w_pad, sq_norms, idx, active, y)
    a_out, w_out = alpha.clone(), w_pad.clone()
    m = idx.shape[0]
    if m == 0:
        return a_out, w_out
    plan = dcd_ell_plan(m, cols.shape[1], wide)
    _launch(plan, idx, m, 0, cols, vals, a_out, w_out, sq_norms, active, y,
            loss)
    dcd_ell_epoch.launches += 1
    dcd_ell_epoch.variant_launches[plan.variant] += 1
    return a_out, w_out


dcd_ell_epoch.launches = 0
dcd_ell_epoch.variant_launches = {"staged": 0, "wide": 0}


def dcd_ell_shards_plain(cols, vals, alpha, w_eff, sq_norms, *, loss, idx,
                         n_loc, active=None, y=None):
    """The plain version of B1 over a grid of p data shards: shard s, in
    shard order, runs its ids ``idx[s]`` (rows s·n_loc + id) against
    ``w_eff`` (or ``w_eff[s]`` when it is (p, d+1)), as
    ``dcd_ell_epoch_plain`` does.  Returns (α, Δw (p, d+1)), shard s's
    Δw = w_new − its w_eff; the shards' rows are disjoint, so their α
    updates do not meet.  A (K, n) α is K tasks (``task_grid``): task k,
    in task order, runs the shard grid on its own α, w, ids, act and y;
    returns (α (K, n), Δw (K, p, d+1))."""
    if alpha.dim() == 2:
        return task_loop(dcd_ell_shards_plain, (cols, vals), alpha, w_eff,
                          sq_norms, loss, idx, n_loc, active, y)
    dws = []
    for s in range(idx.shape[0]):
        w_s = w_eff[s] if w_eff.dim() == 2 else w_eff
        alpha, w_new = dcd_ell_epoch_plain(
            cols, vals, alpha, w_s, sq_norms, loss=loss,
            idx=idx[s].long() + s * n_loc, active=active, y=y)
        dws.append(w_new - w_s)
    return alpha, torch.stack(dws)


def task_grid(alpha, idx, active, y):
    """The task layout of a shard-grid call, the multi-task solver's
    round: ``alpha`` (K, n) is K tasks (a 1-D α is one, the binary
    layout); ``idx`` (p, B), one block for every task, or (K, p, B);
    ``active`` (n,), one mask for every task, or (K, n); ``y`` (K, n)
    ±1 labels folded on read (in the binary layout α, act and y are
    (n,)).  Returns (K, the task strides in words of the ids, of α and
    y, and of act), raising on shapes that do not match."""
    tasks = alpha.dim() == 2
    K, n = alpha.shape if tasks else (1, alpha.shape[0])
    lead = (K,) if tasks else ()
    p, m = idx.shape[-2:]
    if idx.dim() == 3 and (not tasks or idx.shape[0] != K):
        raise ValueError(f"idx must be (p, B) or ({K}, p, B)")
    if y is not None and tuple(y.shape) != (*lead, n):
        raise ValueError(f"y must have shape {(*lead, n)}")
    if active is not None and tuple(active.shape) not in ((n,),
                                                          (*lead, n)):
        raise ValueError(f"active must have shape ({n},) or {(*lead, n)}")
    act_ts = n if active is not None and active.dim() == 2 else 0
    return K, p * m if idx.dim() == 3 else 0, n, act_ts


def task_loop(plain, X, alpha, w_eff, sq_norms, loss, idx, n_loc, active,
               y, **kw):
    """Run a shard-grid plain version once per task, in task order, on
    the task's α, w, ids, act and y; returns (α (K, n), Δw or the
    replicas, stacked over the tasks)."""
    outs = [plain(*X, alpha[t], w_eff[t], sq_norms, loss=loss,
                  idx=idx[t] if idx.dim() == 3 else idx, n_loc=n_loc,
                  active=(active[t] if active is not None
                          and active.dim() == 2 else active),
                  y=None if y is None else y[t], **kw)
            for t in range(alpha.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def dcd_ell_shards(cols, vals, alpha, w_eff, sq_norms, *, loss, idx, n_loc,
                   active=None, y=None, wide=False):
    """B1 over a grid of p data shards: ``idx`` (p, B) int32 shard-local
    ids, shard s owning rows [s·n_loc, (s+1)·n_loc) of the (n, k) shard
    layout; ``w_eff`` the (d+1,) primal every shard reads, or (p, d+1),
    one a shard.  Returns (α, Δw (p, d+1)), the shards' own updates,
    which the caller sums in shard order.  With a (K, n) α the grid has
    a task dimension (``task_grid``: w_eff (K, d+1) or (K, p, d+1), idx
    (p, B) or (K, p, B), y (K, n), active (n,) or (K, n)) and returns
    (α (K, n), Δw (K, p, d+1)).  CUDA tensors launch one kernel of
    K × p CTAs (counted in ``dcd_ell_shards.launches``, under its
    variant, and in ``dcd_ell_shards.task_launches`` when K > 1); CPU
    tensors run ``dcd_ell_shards_plain``.  The staged kernel writes each
    pair's Δw slice into zeros; the wide kernel updates a replica of w a
    pair, which the wrapper fills, and Δw is replica − w_eff.
    ``wide=True`` launches the wide variant whatever the shape."""
    if alpha.device.type != "cuda":
        return dcd_ell_shards_plain(cols, vals, alpha, w_eff, sq_norms,
                                    loss=loss, idx=idx, n_loc=n_loc,
                                    active=active, y=y)
    tasks = alpha.dim() == 2
    idx, w_eff = idx.contiguous(), w_eff.contiguous()
    K, idx_ts, row_ts, act_ts = task_grid(alpha, idx, active, y)
    p, m = idx.shape[-2:]
    W = w_eff if tasks else w_eff[None]  # (K, d+1) or (K, p, d+1)
    d1 = W.shape[-1]
    if W.dim() not in (2, 3) or W.shape[0] != K or (W.dim() == 3
                                                    and W.shape[1] != p):
        raise ValueError(f"w_eff must be (d+1,) or ({p}, d+1), a task each")
    _check_grid(cols, vals, alpha, W, sq_norms, idx, active, y)
    a_out = alpha.clone()
    lead = (K,) if tasks else ()
    if m == 0:
        return a_out, torch.zeros((*lead, p, d1), dtype=torch.float32,
                                  device=alpha.device)
    plan = dcd_ell_plan(m, cols.shape[1], wide, p, K)
    w_ts = W[0].numel()
    if plan.variant == "staged":
        dw = torch.zeros((*lead, p, d1), dtype=torch.float32,
                         device=alpha.device)
        _launch(plan, idx, m, n_loc, cols, vals, a_out, W, sq_norms,
                active, y, loss, w_stride=d1 if W.dim() == 3 else 0, dw=dw,
                strides=(idx_ts, row_ts, act_ts, w_ts))
    else:
        Wp = W if W.dim() == 3 else W[:, None]
        rep = Wp.expand(K, p, d1).clone(
            memory_format=torch.contiguous_format)
        _launch(plan, idx, m, n_loc, cols, vals, a_out, rep, sq_norms,
                active, y, loss, strides=(idx_ts, row_ts, act_ts, 0))
        dw = (rep - Wp).view(*lead, p, d1)
    dcd_ell_shards.launches += 1
    dcd_ell_shards.variant_launches[plan.variant] += 1
    dcd_ell_shards.task_launches += int(K > 1)
    return a_out, dw


dcd_ell_shards.launches = 0
dcd_ell_shards.variant_launches = {"staged": 0, "wide": 0}
dcd_ell_shards.task_launches = 0
