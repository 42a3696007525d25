"""B4 and B5: the feature-sharded (2-D) block round — the CUDA kernels
``csrc/dcd_feature.cu`` and their plain PyTorch versions.

The 2-D solver holds the features in m contiguous shards
(``repro_torch.data.sparse.FeatureShardedEll``):

  cols: (n, m, k) int32 shard-local column ids, padding == d_loc
  vals: (n, m, k) float32 values, padding == 0.0
  w:    (m, d1) float32 primal slices, d1 = d_loc + 1, the dummy slot at
        local index d_loc

A block of B sequential updates rests on wᵀx_t = base_t + Σ_{s<t} δ̃_s·
G[s, t], base_t = w₀ᵀx_t and G the block's Gram matrix, both sums over
the shards:

* B4, ``dcd_feature_gram``, replaces the Pallas TPU kernel
  ``repro/kernels/dcd_feature.py:_gram_kernel``: every shard's partial
  base (m, B) and Gram (m, B, B) for the block ``idx``.  The caller sums
  them over the shard dimension (the reference's psum over ``model``).
* B5, ``dcd_feature_update``, replaces ``_update_kernel``: the B-step δ
  recursion against the summed (base, G) — wx_t = y_t·(base_t +
  Σ_s δ̃_s·G[s, t]), δ gated by ``active``, α_i += δ, δ̃_t = δ·y_t — and
  the scatter of δ̃_t·vals_t into every shard's own slice.  Its kernel
  scatters by B4's column classes, from the buckets B4 left in the
  workspace for the same block (or, without one, from its own bucket
  pass); its layout is ``repro_torch.dist.mesh.feature_update_plan``'s.

A block past ``GRAM_SHARED_MAX_IDS`` = 1,024 ids (the shim's one block of
B = n rows) takes both kernels' "rows" layout (``gram_plan``): one column
class, G written in row tiles to device memory, B5's recursion in panels
of 32 steps on a thread-block cluster of CTAs a (task, data shard) pair
— a serial warp running each panel with shuffles, each CTA's worker
warps applying its δ̃ to the CTA's columns ahead while its producer warp
streams them through a ring — its accumulators in shared memory (device
memory past what fits) and δ̃ in device memory, then the scatter.  Below it every launch keeps its layout
and its bits.

Both take a grid of p data shards: a (p, B) ``idx`` of shard-local ids
(shard s's rows are [s·n_loc, (s+1)·n_loc)), a shared (m, d1) w or one
(p, m, d1) w a data shard; B4 then returns (p, m, B) and (p, m, B, B),
and B5 each data shard's updated replica of the slices, (p, m, d1).
Both also take K tasks of the multi-task solver (B4 with ``tasks=True``,
B5 with a (K, n) α): a leading K on w, ids (p, B) shared by every task
or (K, p, B), labels y (K, n), act (n,) or (K, n); B4 returns
(K, p, m, B) and (K, p, m, B, B), B5 (K, n) α and the (K, p, m, d1)
replicas.  Each (task, data shard) pair computes its own base and Gram,
as the reference's vmapped kernel does.  With one (m, d1) view of w a
pod, (P, m, d1) or (K, P, m, d1) for 1 < P < p (the pod solver), the p
data shards are P pods of p / P each, data shard s of pod s // (p / P):
pod k's shards read pod k's w, and B5's replicas are filled from it
(``dcd_ell.pod_grid``).

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back from one to the other.  B4
buckets the block's entries by column class into a workspace
(``gram_workspace``: the bucketed entries, each row's class offsets and
the per-class partial Grams, about 15 MB at webspam), which the solver
allocates once per solve; its layout is ``repro_torch.dist.mesh.
gram_plan``'s.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.duals import kernel_params
from repro_torch.data.sparse import flat_shard_ids
from repro_torch.dist.mesh import (
    FEATURE_UPDATE_CHUNK,
    GRAM_BUCKET_THREADS,
    GRAM_CHUNK,
    GRAM_ROWS_THREADS,
    GRAM_TABLE_SLOTS,
    GRAM_THREADS,
    feature_update_plan,
    gram_plan,
)
from repro_torch.kernels import build
from repro_torch.kernels.build import F, I, L, P
from repro_torch.kernels.dcd_ell import pod_grid, pod_row


class GramWorkspace(NamedTuple):
    """B4's device workspace for blocks of b ids over (n, m, k) slices
    of d1-word shards: each block row's real entries bucketed by column
    class (local column ``lc`` and value ``v``, (m, b, k)), each row's
    class offsets ((m, b, R + 1)), and the per-class partial Grams
    ((m, R, b, b); empty when there is one class) — with p data shards
    of K tasks, K·p·m in place of m.  ``m_all`` is the mesh's feature
    shard count where these m are one rank's (0: m): the launches that
    use the workspace lay out their column classes for it
    (``gram_plan``)."""

    lc: torch.Tensor
    v: torch.Tensor
    roff: torch.Tensor
    part: torch.Tensor
    m_all: int = 0


def gram_workspace(m: int, b: int, k: int, d1: int, device,
                   data: int = 1, tasks: int = 1,
                   m_all: int = 0) -> GramWorkspace:
    """Allocate B4's workspace for blocks of ``b`` ids (uninitialised:
    every launch writes what it reads), one for each of ``data`` data
    shards of each of ``tasks`` tasks: the leading dimension indexes the
    (task, data, model) triples, task t's data shard s's model shard j
    at (t·data + s)·m + j.  ``m_all``: the mesh's feature shards where
    these m are one rank's (``gram_plan``)."""
    plan = gram_plan(m, b, k, d1, data, tasks, m_all=m_all)
    parts = plan.classes if plan.classes > 1 else 0
    pm = plan.tasks * plan.data * m
    return GramWorkspace(
        torch.empty((pm, b, k), dtype=torch.int32, device=device),
        torch.empty((pm, b, k), dtype=torch.float32, device=device),
        torch.empty((pm, b, plan.classes + 1), dtype=torch.int32,
                    device=device),
        torch.empty((pm, parts, b, b), dtype=torch.float32, device=device),
        int(m_all))


def _check_block(cols, vals, w, idx, tasks=False):
    n, m, k = cols.shape
    shards = idx.shape[-2] if idx.dim() > 1 else 1
    views = w.shape[-3] if w.dim() == (4 if tasks else 3) else 1
    if tasks:
        K = w.shape[0]
        ok = (w.dim() in (3, 4) and w.shape[-2] == m and idx.dim() in (2, 3)
              and (idx.dim() == 2 or idx.shape[0] == K)
              and shards % views == 0)
        if not ok:
            raise ValueError(f"expected w (K, {m}, d_loc+1) or (K, g, {m}, "
                             "d_loc+1) for g | p, and idx (p, B) or "
                             "(K, p, B)")
    elif idx.dim() == 1:
        ok = w.dim() == 2 and w.shape[0] == m
    else:
        ok = idx.dim() == 2 and shards % views == 0 and (
            (w.dim() == 2 and w.shape[0] == m)
            or (w.dim() == 3 and w.shape[1] == m))
    if not ok:
        raise ValueError(f"expected idx (B,) and w ({m}, d_loc+1), or idx "
                         f"(p, B) and w ({m}, d_loc+1) or (g, {m}, d_loc+1) "
                         "for g | p (a view a data shard, or a view a pod)")
    if idx.shape[-1] < 1:
        raise ValueError("the block must hold at least one id")


def _check_workspace(workspace, pm, b, k, plan, device):
    """The buckets of a workspace for this shape (``gram_workspace``)."""
    build.check_operands(device, {
        "lc": (workspace.lc, (pm, b, k)), "v": (workspace.v, (pm, b, k)),
        "roff": (workspace.roff, (pm, b, plan.classes + 1))},
        int32=("lc", "roff"))


def _grid(idx, w, tasks):
    """The grid of a call: (K, p, idx, the ids' task stride, w's stride
    between its views (0: one w for every data shard), w's task stride,
    the data shards a view serves, the pods P), in words.  A 1-D ``idx``
    is one data shard, a call without ``tasks`` one task."""
    W = w if tasks else w[None]
    if idx.dim() == 1:
        idx = idx[None]
    K, p, b = W.shape[0], idx.shape[-2], idx.shape[-1]
    n_pods, _, pod_shards = pod_grid(W.flatten(-2), K, p)
    return (K, p, idx, p * b if idx.dim() == 3 else 0,
            W[0, 0].numel() if W.dim() == 4 else 0, W[0].numel(),
            pod_shards, n_pods)


def dcd_feature_gram_plain(cols, vals, w, idx, n_loc: int = 0,
                           tasks: bool = False):
    """The plain version of B4, step by step as the Pallas kernel: gather
    the block's rows, base = Σ w[cols]·vals, then for each t scatter row
    t into a zeroed scratch, gather every row of the block against it
    for column G[:, t], and zero the slots row t touched.  All m shards
    at once.  Returns (base_p (m, B), gram_p (m, B, B)); for a (p, B)
    ``idx`` of p data shards (rows s·n_loc + id, against w or w[s]),
    each shard in order, (p, m, B) and (p, m, B, B).  With ``tasks``
    (w (K, …), idx (p, B) or (K, p, B)) each task in order:
    (K, p, m, B) and (K, p, m, B, B)."""
    if tasks:
        outs = [dcd_feature_gram_plain(cols, vals, w[t],
                                       idx[t] if idx.dim() == 3 else idx,
                                       n_loc)
                for t in range(w.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    if idx.dim() == 2:
        outs = [dcd_feature_gram_plain(cols, vals,
                                       w[pod_row(s, idx.shape[0], w)]
                                       if w.dim() == 3 else w,
                                       idx[s].long() + s * n_loc)
                for s in range(idx.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    d1 = w.shape[1]
    m, b = cols.shape[1], idx.shape[0]
    ids = flat_shard_ids(cols[idx.long()], d1).transpose(0, 1)  # (m, B, k)
    vb = vals[idx.long()].transpose(0, 1)
    w_flat = w.reshape(-1)
    base = torch.sum(w_flat[ids] * vb, dim=2)
    scratch = torch.zeros((m * d1,), dtype=torch.float32, device=w.device)
    gram = torch.empty((m, b, b), dtype=torch.float32, device=w.device)
    for t in range(b):
        ct = ids[:, t].reshape(-1)
        scratch.index_add_(0, ct, vb[:, t].reshape(-1))
        gram[:, :, t] = torch.sum(scratch[ids] * vb, dim=2)
        scratch[ct] = 0.0
    return base, gram


def dcd_feature_gram(cols, vals, w, idx, *, workspace=None, n_loc: int = 0,
                     tasks: bool = False):
    """Every shard's partial (base, Gram) of the block ``idx`` (int32 row
    ids in [0, n), repeats allowed) against the primal slices ``w``.
    A (p, B) ``idx`` is p data shards, shard s's ids local to its rows
    [s·n_loc, (s+1)·n_loc), against ``w`` (m, d1) or its own ``w[s]``
    of a (p, m, d1) ``w``.  CUDA tensors launch B4 (its bucket, Gram and
    reduction kernels over every (data, model) pair, counted once in
    ``dcd_feature_gram.launches``) with ``workspace`` (``gram_workspace``
    for this shape; allocated for this call when None); CPU tensors run
    the plain version.  Returns (base_p (m, B), gram_p (m, B, B)), with
    a leading p for a (p, B) ``idx``.  ``tasks``: w carries a leading K
    ((K, m, d1), or (K, p, m, d1) a replica a data shard) and ``idx`` is
    (p, B), one block for every task, or (K, p, B); one launch over the
    K·p pairs (``dcd_feature_gram.task_launches`` counts those with
    K > 1) returns (K, p, m, B) and (K, p, m, B, B).  A w of P views
    for 1 < P < p, (P, m, d1) or (K, P, m, d1), makes the p data shards
    P pods' (module docstring), also counted in
    ``dcd_feature_gram.pod_launches``.  Where cols, vals and w hold one
    rank's m of the mesh's feature shards, the workspace's ``m_all``
    keeps the whole mesh's column classes (``gram_plan``)."""
    if w.device.type != "cuda":
        return dcd_feature_gram_plain(cols, vals, w, idx, n_loc, tasks)
    _check_block(cols, vals, w, idx, tasks)
    lead = (w.shape[0], idx.shape[-2]) if tasks else idx.shape[:-1]
    (K, p, idx, idx_ts, w_stride, w_ts, pod_shards,
     n_pods) = _grid(idx.contiguous(), w, tasks)
    n, m, k = cols.shape
    d1, b = w.shape[-1], idx.shape[-1]
    m_all = workspace.m_all if workspace is not None else 0
    plan = gram_plan(m, b, k, d1, p // n_pods, K, n_pods, m_all)
    if workspace is None:
        workspace = gram_workspace(m, b, k, d1, w.device, p, K)
    parts = plan.classes if plan.classes > 1 else 0
    kpm = K * p * m
    _check_workspace(workspace, kpm, b, k, plan, w.device)
    build.check_operands(w.device, {
        "cols": (cols, None), "vals": (vals, (n, m, k)), "w": (w, None),
        "idx": (idx, None), "part": (workspace.part, (kpm, parts, b, b))},
        int32=("cols", "idx"))
    base_p = torch.empty((*lead, m, b), dtype=torch.float32, device=w.device)
    gram_p = torch.empty((*lead, m, b, b), dtype=torch.float32,
                         device=w.device)
    rows = plan.layout == "rows"
    launch = build.entry("dcd_feature", "dcd_feature_gram_launch",
                         [P, I, I, L, P, P, I, I, I, P, L, I, I, I, I, I, I,
                          I, I, I, I, P, P, P, P, P, P, I, L, L, I, I, P])
    with torch.cuda.device(w.device):
        err = launch(build.ptr(idx), b, p, n_loc, build.ptr(cols),
                     build.ptr(vals), m, k, d1 - 1, build.ptr(w), w_stride,
                     d1, plan.classes, plan.tile, plan.tiles, GRAM_CHUNK,
                     GRAM_TABLE_SLOTS, GRAM_BUCKET_THREADS, plan.bucket_smem,
                     GRAM_ROWS_THREADS if rows else GRAM_THREADS,
                     plan.gram_smem, build.ptr(workspace.lc),
                     build.ptr(workspace.v), build.ptr(workspace.roff),
                     build.ptr(workspace.part), build.ptr(base_p),
                     build.ptr(gram_p), K, idx_ts, w_ts, pod_shards,
                     int(rows), build.stream())
    build.check(err, "dcd_feature_gram_launch")
    dcd_feature_gram.launches += 1
    dcd_feature_gram.rows_launches += int(rows)
    dcd_feature_gram.task_launches += int(K > 1)
    dcd_feature_gram.pod_launches += int(n_pods > 1)
    return base_p, gram_p


dcd_feature_gram.launches = 0
dcd_feature_gram.task_launches = 0
dcd_feature_gram.pod_launches = 0
dcd_feature_gram.rows_launches = 0


def dcd_feature_update_plain(cols, vals, alpha, sq_norms, w, idx, base,
                             gram, *, loss, active=None, y=None,
                             n_loc: int = 0):
    """The plain version of B5, step by step as the Pallas kernel: the
    δ̃ history starts at 0, wx_t = y_t·(base_t + Σ δ̃·G[:, t]), α is read
    from the running output, and δ̃_t·vals_t scatters into every shard's
    slice.  Returns new (α, w); the inputs are not changed.  For a
    (p, B) ``idx`` of p data shards (rows s·n_loc + id; base (p, B),
    gram (p, B, B)), each shard in order against w, or its own w[s] of
    a (p, m, d1) w: returns (α, the shards' updated w (p, m, d1)).  A
    (K, n) α is K tasks (as ``dcd_feature_update``), each in order:
    (α (K, n), the replicas (K, p, m, d1))."""
    if alpha.dim() == 2:
        outs = [dcd_feature_update_plain(
            cols, vals, alpha[t], sq_norms, w[t],
            idx[t] if idx.dim() == 3 else idx, base[t], gram[t], loss=loss,
            active=(active[t] if active is not None and active.dim() == 2
                    else active),
            y=None if y is None else y[t], n_loc=n_loc)
            for t in range(alpha.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    if idx.dim() == 2:
        ws = []
        for s in range(idx.shape[0]):
            alpha, w_s = dcd_feature_update_plain(
                cols, vals, alpha, sq_norms,
                w[pod_row(s, idx.shape[0], w)] if w.dim() == 3 else w,
                idx[s].long() + s * n_loc, base[s], gram[s], loss=loss,
                active=active, y=y)
            ws.append(w_s)
        return alpha, torch.stack(ws)
    alpha, w = alpha.clone(), w.clone()
    d1, b = w.shape[1], idx.shape[0]
    w_flat = w.reshape(-1)
    deltas = torch.zeros((b,), dtype=torch.float32, device=w.device)
    for t, i in enumerate(idx.tolist()):
        yi = y[i] if y is not None else 1.0
        wx = yi * (base[t] + torch.sum(deltas * gram[:, t]))
        a = alpha[i]
        delta = loss.delta(a, wx, sq_norms[i])
        if active is not None:
            delta = torch.where(active[i] > 0.0, delta, 0.0)
        alpha[i] = a + delta
        dtil = delta * yi
        w_flat.index_add_(0, flat_shard_ids(cols[i], d1).reshape(-1),
                          (dtil * vals[i]).reshape(-1))
        deltas[t] = dtil
    return alpha, w


def dcd_feature_update(cols, vals, alpha, sq_norms, w, idx, base, gram, *,
                       loss, active=None, y=None, workspace=None,
                       n_loc: int = 0):
    """The block's B sequential updates against the summed (base, gram);
    ``sq_norms`` are the full row norms.  A (p, B) ``idx`` is p data
    shards (as ``dcd_feature_gram``; base (p, B), gram (p, B, B)), each
    updating its own replica of the (m, d1) slices.  CUDA tensors launch
    B5 (R × p·m CTAs, R B4's column classes; counted in
    ``dcd_feature_update.launches``); CPU tensors run the plain version
    and ignore ``workspace``.  ``workspace`` must hold B4's buckets of
    this same block ``idx`` (``dcd_feature_gram`` with it, since the
    last call that filled it); with None, B5 buckets the block itself in
    the same launch, to the same bits.  Returns new (α, w) — with a
    (p, B) ``idx``, w is the p replicas (p, m, d1).  A (K, n) α is K
    tasks: w (K, m, d1) or (K, p, m, d1), idx (p, B) or (K, p, B), base
    (K, p, B), gram (K, p, B, B), y (K, n), active (n,) or (K, n); one
    launch of R × K·p·m CTAs (``dcd_feature_update.task_launches``
    counts those with K > 1) returns (α (K, n), the replicas (K, p, m,
    d1)).  A w of P views for 1 < P < p, (P, m, d1) or (K, P, m, d1),
    makes the p data shards P pods', each data shard's replica filled
    from its pod's view; counted also in
    ``dcd_feature_update.pod_launches``.  The workspace's ``m_all``:
    as for ``dcd_feature_gram``."""
    if w.device.type != "cuda":
        return dcd_feature_update_plain(cols, vals, alpha, sq_norms, w, idx,
                                        base, gram, loss=loss,
                                        active=active, y=y, n_loc=n_loc)
    tasks = alpha.dim() == 2
    _check_block(cols, vals, w, idx, tasks)
    sharded = tasks or idx.dim() == 2
    K, p, idx, idx_ts, _, _, _, n_pods = _grid(idx.contiguous(), w, tasks)
    n, m, k = cols.shape
    d1, b = w.shape[-1], idx.shape[-1]
    if tasks and ((y is not None and tuple(y.shape) != (K, n))
                  or (active is not None
                      and tuple(active.shape) not in ((n,), (K, n)))):
        raise ValueError(f"y must be ({K}, {n}), active ({n},) or "
                         f"({K}, {n})")
    lead = (K,) if tasks else ()
    m_all = workspace.m_all if workspace is not None else 0
    plan = feature_update_plan(m, b, k, d1, p // n_pods, K, n_pods, m_all)
    gplan = gram_plan(m, b, k, d1, p // n_pods, K, n_pods, m_all)
    bucket = workspace is None
    if bucket:
        workspace = gram_workspace(m, b, k, d1, w.device, p, K)
    _check_workspace(workspace, K * p * m, b, k, gplan, w.device)
    base, gram = base.contiguous(), gram.contiguous()
    row = (*lead, n)
    build.check_operands(w.device, {
        "cols": (cols, None), "vals": (vals, (n, m, k)),
        "alpha": (alpha, row), "sq_norms": (sq_norms, (n,)),
        "active": (active, None if tasks else (n,)), "y": (y, row),
        "w": (w, None), "idx": (idx, None),
        "base": (base.view(K * p, b), (K * p, b)),
        "gram": (gram.view(K * p, b, b), (K * p, b, b))},
        int32=("cols", "idx"))
    act_ts = n if active is not None and active.dim() == 2 else 0
    a_out = alpha.clone()
    # each (task, data shard) pair's replica of the slices, which its CTAs
    # update, filled from the view its shard reads
    if sharded:
        Wp = w.view(K, -1, 1, m, d1)
        g = Wp.shape[1]
        w_out = Wp.expand(K, g, p // g, m, d1).clone(
            memory_format=torch.contiguous_format).view(*lead, p, m, d1)
    else:
        w_out = w.clone()
    rows = plan.layout == "rows"
    # the rows layout's δ̃ (and accumulators, where shared memory cannot
    # hold them) in device memory, a row a (task, data shard) pair
    dtil = (torch.empty((K * p, b), dtype=torch.float32, device=w.device)
            if rows else None)
    acc = (torch.empty((K * p, b), dtype=torch.float32, device=w.device)
           if rows and not plan.acc_shared else None)
    launch = build.entry("dcd_feature", "dcd_feature_update_launch",
                         [P, I, I, L, P, P, I, I, I, P, P, P, P, P, P, I, P,
                          P, I, F, F, F, I, I, I, I, I, I, I, I, I, I, P, P,
                          P, I, L, L, L, I, P, P, I, I, P])
    with torch.cuda.device(w.device):
        err = launch(build.ptr(idx), b, p, n_loc, build.ptr(cols),
                     build.ptr(vals), m, k, d1 - 1, build.ptr(alpha),
                     build.ptr(a_out), build.ptr(sq_norms),
                     build.ptr(active), build.ptr(y), build.ptr(w_out), d1,
                     build.ptr(base), build.ptr(gram), *kernel_params(loss),
                     plan.classes, plan.per_lane, int(plan.stage_gram),
                     FEATURE_UPDATE_CHUNK, plan.threads, plan.smem_bytes,
                     int(bucket), GRAM_BUCKET_THREADS, gplan.bucket_smem,
                     build.ptr(workspace.lc), build.ptr(workspace.v),
                     build.ptr(workspace.roff), K, idx_ts, n, act_ts,
                     int(rows), build.ptr(acc), build.ptr(dtil),
                     plan.stages, plan.cluster, build.stream())
    build.check(err, "dcd_feature_update_launch")
    dcd_feature_update.launches += 1
    dcd_feature_update.rows_launches += int(rows)
    dcd_feature_update.task_launches += int(K > 1)
    dcd_feature_update.pod_launches += int(n_pods > 1)
    return a_out, w_out


dcd_feature_update.launches = 0
dcd_feature_update.task_launches = 0
dcd_feature_update.pod_launches = 0
dcd_feature_update.rows_launches = 0
