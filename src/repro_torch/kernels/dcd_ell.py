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
``data``).
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


def _launch(plan, idx, m, n_loc, cols, vals, alpha, w, sq_norms, active, y,
            loss, w_stride=0, dw=None):
    """Launch B1's kernel for ``plan`` on operands already checked:
    ``plan.shards`` CTAs of ``m`` ids each.  The staged kernel writes the
    shards' Δw slices into ``dw`` (or, with one shard and no ``dw``,
    updates ``w`` in place); the wide kernel updates ``w`` in place, a
    replica a shard."""
    k = cols.shape[1]
    d = (w.shape[-1] if dw is None else dw.shape[-1]) - 1
    args = [build.ptr(idx), m, plan.shards, n_loc, build.ptr(cols),
            build.ptr(vals), k, d, build.ptr(alpha), build.ptr(sq_norms),
            build.ptr(active), build.ptr(y), build.ptr(w)]
    types = [P, I, I, L, P, P, I, I, P, P, P, P, P]
    if plan.variant == "staged":
        fn = "dcd_ell_staged_launch"
        types += [L, P, I, F, F, F, I, I, I, I, P]
        args += [w_stride, build.ptr(dw), *kernel_params(loss),
                 plan.table_slots, plan.threads, plan.smem_bytes]
    else:
        fn = "dcd_ell_launch"
        types += [I, F, F, F, I, I, P]
        args += [*kernel_params(loss), plan.threads]
    launch = build.entry("dcd_ell", fn, types)
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
    updates do not meet."""
    dws = []
    for s in range(idx.shape[0]):
        w_s = w_eff[s] if w_eff.dim() == 2 else w_eff
        alpha, w_new = dcd_ell_epoch_plain(
            cols, vals, alpha, w_s, sq_norms, loss=loss,
            idx=idx[s].long() + s * n_loc, active=active, y=y)
        dws.append(w_new - w_s)
    return alpha, torch.stack(dws)


def dcd_ell_shards(cols, vals, alpha, w_eff, sq_norms, *, loss, idx, n_loc,
                   active=None, y=None, wide=False):
    """B1 over a grid of p data shards: ``idx`` (p, B) int32 shard-local
    ids, shard s owning rows [s·n_loc, (s+1)·n_loc) of the (n, k) shard
    layout; ``w_eff`` the (d+1,) primal every shard reads, or (p, d+1),
    one a shard.  Returns (α, Δw (p, d+1)), the shards' own updates,
    which the caller sums in shard order.  CUDA tensors launch one
    kernel of p CTAs (counted in ``dcd_ell_shards.launches`` and under
    its variant); CPU tensors run ``dcd_ell_shards_plain``.  The staged
    kernel writes each shard's Δw slice into zeros; the wide kernel
    updates a replica of w a shard, which the wrapper fills, and Δw is
    replica − w_eff.  ``wide=True`` launches the wide variant whatever
    the shape."""
    if alpha.device.type != "cuda":
        return dcd_ell_shards_plain(cols, vals, alpha, w_eff, sq_norms,
                                    loss=loss, idx=idx, n_loc=n_loc,
                                    active=active, y=y)
    idx, w_eff = idx.contiguous(), w_eff.contiguous()
    p, m = idx.shape
    d1 = w_eff.shape[-1]
    if w_eff.dim() not in (1, 2) or (w_eff.dim() == 2
                                     and w_eff.shape[0] != p):
        raise ValueError(f"w_eff must be (d+1,) or ({p}, d+1)")
    _check(cols, vals, alpha, w_eff.view(-1), sq_norms, idx.view(-1),
           active, y)
    a_out = alpha.clone()
    if m == 0:
        return a_out, torch.zeros((p, d1), dtype=torch.float32,
                                  device=alpha.device)
    plan = dcd_ell_plan(m, cols.shape[1], wide, p)
    if plan.variant == "staged":
        dw = torch.zeros((p, d1), dtype=torch.float32, device=alpha.device)
        _launch(plan, idx, m, n_loc, cols, vals, a_out, w_eff, sq_norms,
                active, y, loss, w_stride=d1 if w_eff.dim() == 2 else 0,
                dw=dw)
    else:
        rep = w_eff.expand(p, d1).clone(memory_format=torch.contiguous_format)
        _launch(plan, idx, m, n_loc, cols, vals, a_out, rep, sq_norms,
                active, y, loss)
        dw = rep - w_eff
    dcd_ell_shards.launches += 1
    dcd_ell_shards.variant_launches[plan.variant] += 1
    return a_out, dw


dcd_ell_shards.launches = 0
dcd_ell_shards.variant_launches = {"staged": 0, "wide": 0}
