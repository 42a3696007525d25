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
"""

from __future__ import annotations

import torch

from repro_torch.core.duals import kernel_params
from repro_torch.dist.mesh import dcd_ell_plan
from repro_torch.kernels import build
from repro_torch.kernels.build import F, I, P


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
    m, k = idx.shape[0], cols.shape[1]
    if m == 0:
        return a_out, w_out
    plan = dcd_ell_plan(m, k, wide)
    args = [build.ptr(idx), m, build.ptr(cols), build.ptr(vals), k,
            w_pad.shape[0] - 1, build.ptr(a_out), build.ptr(sq_norms),
            build.ptr(active), build.ptr(y), build.ptr(w_out),
            *kernel_params(loss)]
    types = [P, I, P, P, I, I, P, P, P, P, P, I, F, F, F, I]
    if plan.variant == "staged":
        fn = "dcd_ell_staged_launch"
        types += [I, I, I, P]
        args += [plan.table_slots, plan.threads, plan.smem_bytes]
    else:
        fn = "dcd_ell_launch"
        types += [I, P]
        args += [plan.threads]
    launch = build.entry("dcd_ell", fn, types)
    with torch.cuda.device(alpha.device):
        err = launch(*args, build.stream())
    build.check(err, fn)
    dcd_ell_epoch.launches += 1
    dcd_ell_epoch.variant_launches[plan.variant] += 1
    return a_out, w_out


dcd_ell_epoch.launches = 0
dcd_ell_epoch.variant_launches = {"staged": 0, "wide": 0}
