"""PASSCoDe-Atomic on one GPU — the pipelined solver of
``repro/core/sharded.py`` over p ``data`` shards, on the 1-D
``("data",)`` mesh and on the 2-D ``("data", "model")`` mesh, with the
reference's self-tuning (shrinking, repacking, the adaptive delay).

The reference shards rows over p devices; each device runs a *block* of
B locally-sequential DCD updates against its view of w, then the
per-device Δw are psummed (atomic semantics, staleness τ ≤ B·(p−1)), or
folded in one round late with ``delay_rounds ≥ 1``.  On one card the p
devices are p virtual shards (``solver_mesh(n_devices=p)``,
``solver_mesh_2d(data=p, model=m)``): shard s owns rows [s·n_loc,
(s+1)·n_loc), n_loc = ⌈n/p⌉, the tail padded with zero rows (q = 1)
that the draw never selects where a shard owns a real row.  A round is
one launch of the block engine over all p shards (a CTA, or a group of
CTAs, a shard), each shard's B updates in order against the round's
w_eff, returning each shard's Δw; their sum in shard order is the psum.
At p = 1 the sum is the identity and the solve is serial DCD in the
block-draw order.  The round structure is kept exactly — per round
(α, Δw = w_new − w), then w += Δw — because the Δw round trip rounds
differently from carrying w, and parity with the reference relies on
doing the same.

**1-D mesh.**  w is one (d+1,) padded primal (ELL, dummy slot at d) or
(d,) vector (dense).  Per round the block engine is the B1 wrapper
(``repro_torch.kernels.ops.dcd_ell_block_update``) on an ``EllMatrix``,
or the B2 wrapper (``dcd_block_update``) on a dense X, given the round's
(p, B) shard-local ids.  Each launches its CUDA kernel for tensors on
the card and runs the kernel's plain version for tensors on the CPU.

**2-D mesh** (``mesh=solver_mesh_2d(data=p, model=m)``, the webspam/kddb
regime of the reference's DESIGN.md §10).  The reference's ``model``
axis becomes m virtual feature shards on the one card: X is split into
a ``FeatureShardedEll`` ((n, m, k_loc) shard-local slices) and w is an
(m, d_loc + 1) tensor, one primal slice per row with its dummy slot at
local index d_loc; the psum over ``model`` becomes a sum over the shard
dimension.  A legacy ``("model",)`` mesh maps to (data = 1, model = m).
Two engines, resolved as the reference's ``_resolve_kernel_mode_feature``
("auto" fuses only on the card):

  use_kernel   on cuda                        on cpu
  "auto"       fused (B4 → sum → B5 kernels)  unfused
  True         fused (kernels)                fused (B4/B5 plain versions)
  False        raises                         unfused

The unfused engine (``_local_block_update_feature``) sums the shards'
partial dots per update; the fused engine batches a block's B sums into
one (base, Gram) sum per data shard between B4 and B5.  With
``delay_rounds ≥ 1`` the fused engine double-buffers the round
(``overlap``, resolved by ``repro_torch.dist.mesh.pipeline_overlap``):
the (base, Gram) of block t + 1 is formed while block t's is consumed,
its stale base repaired by ``dcd_feature_base_correction``, and the
aggregate in flight is carried across epochs — each epoch peeks the next
epoch's first block through the key chain.

**The draw.**  Each epoch draws every shard's blocks through the
reference's ``jax.random`` key chain, bit-exact (``repro_torch.prng``):
``key = PRNGKey(seed)``, per epoch ``key, sub = split(key)``, then
``split(sub, p)`` and a permutation of each shard's n_loc rows — so a
seed gives the reference's updates.  ``blocks=`` replaces the draw with
an explicit schedule: (epochs, n_blocks, B) row ids at p = 1,
(epochs, p, n_blocks, B) shard-local ids at p > 1.

**Self-tuning** (``shrink_every``, ``repack``, ``adaptive``; resolved by
``repro_torch.dist.mesh.resolve_self_tuning``).  Shrinking recomputes an
active mask every ``shrink_every`` epochs from (α, w_eff) and hands it to
the kernels as their ``active`` operand (frozen rows take δ = 0); the
final epoch runs unshrunk.  Repacking draws an epoch whose active
fraction is below ``repack_threshold`` over the compacted active set and
runs only ⌈max shard count / B⌉ rounds: that count is read on the host
once an epoch (the solve's one sync before it returns).  The adaptive
delay carries the delay flag on the device: the gap-trend controller
lowers it at a record (a one-way latch), and while it is set a round
reads w with its own shard's last-round updates but not its peers'
(``_scan_rounds_dyn``).  Duality gaps, the backward-error metric
‖w(α) − ŵ‖, the active fraction and the delay flag are recorded into
preallocated device buffers every ``gap_every`` epochs (and at the
last), over the real rows only.

**Multi-task** (``y`` a (K, n) ±1 one-vs-rest matrix, DESIGN.md §16).
The K binary problems share one unfolded X and run as **one** solve:
the reference vmaps the per-task epoch over a leading (K,) axis, and
here every piece of state carries that leading K — α (K, n_pad), w,
Δw, the shrink mask and the records — and every round is one launch of
the block engine over K × p (task, shard) pairs (``repro_torch.kernels``
with a (K, n) α).  The labels are folded on read, by the kernels and by
every closure that reads X (the gap, the shrink mask): y_i·wᵀx_i and
the rank-1 update (δ·y_i)·x_i, exact sign flips, so K = 1 reproduces the
binary solve on pre-folded rows bit for bit.  Each task draws the
reference's one key chain, so without repacking every task runs the
same blocks (one (p, B) id array at a task stride of 0); the
self-tuning is per task — each class its own shrink mask, repack flag,
round count and adaptive latch, the epoch counter shared — and a
repacked epoch runs the most rounds any task needs, a task past its own
count keeping its state (the reference's ``cond``-skipped round under
the task vmap).  The binary solve is the same code at K = 1 with no
labels.  A ``task`` mesh axis (``solver_mesh_tasks``) is admitted by the
reference's ``task_axis_policy``; on one card its shards are virtual.

**Pods** (a ``pod`` mesh axis, ``solver_mesh_3d``; the reference's
Hybrid-DCA, its DESIGN.md §13).  P pods of p data shards each: pod k
owns the contiguous rows [k·⌈n/P⌉, (k+1)·⌈n/P⌉), padded to its own p·n_loc
slots (``pod_row_layout``), so padding sits inside the row range, one
run of padding a pod.  Each epoch is an outer round from the merged
(α, w): every pod runs its own pipelined epoch — P·p shards in one
launch a round, pod k's shards reading and updating pod k's own w, each
round's Δw summed over the pod's p shards — from a zero Δw carry, its
in-flight inner Δw flushed at the end; then α moves by 1/P of each pod's
progress and g = (1/P)·Σ_pods Δw_pod lands now or through a FIFO of
``pod_delay_rounds`` (``pod_merge_policy`` admits the knobs; under
``adaptive`` the latch is the pod FIFO's, which drains once it drops).
The draw passes each shard's fleet index k·p + my into P·p split keys
with its pod's own valid count.  The gap and ‖w(α) − ŵ‖ reduce over the
fleet's real rows, ŵ the merged (possibly stale) w.  At P = 1 the merge
is the identity: the pod's own (α, w) stand, so a (pod = 1) mesh at
``pod_delay_rounds`` 0 is the plain mesh bit for bit (the reference's
a₀ + (a₁ − a₀) rounds differently from a₁, within atol 1e-5).

The reference's ``pipeline=False`` epoch loop on the host raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.shrinking import active_mask_from_w
from repro_torch.data.sparse import (
    EllMatrix,
    active_row_remap,
    dense_to_ell,
    ell_column_split,
    flat_shard_ids,
)
from repro_torch.dist.mesh import (
    SelfTuning,
    SolverMesh,
    adaptive_delay_policy,
    dp_size,
    pipeline_overlap,
    pod_merge_policy,
    resolve_device,
    resolve_self_tuning,
    solver_mesh_2d,
    task_axis_policy,
)
from repro_torch.kernels.dcd_ell import pod_row
from repro_torch.kernels.dcd_feature import gram_workspace
from repro_torch.kernels.ops import (
    dcd_block_update,
    dcd_ell_block_update,
    dcd_feature_base_correction,
    dcd_feature_block_update,
    dcd_feature_gram,
    dcd_feature_update,
)


class ShardedResult(NamedTuple):
    """A solve's result in user coordinates; a multi-task solve's carry
    a leading K: α (K, n), ŵ (K, d) and each record (K, slots)."""

    alpha: torch.Tensor
    w_hat: torch.Tensor
    gaps: torch.Tensor
    rounds: int
    # per-record metrics, aligned with ``gaps``:
    eps: torch.Tensor | None = None  # ‖w(α) − ŵ‖ (paper §4.2)
    active: torch.Tensor | None = None  # active-set fraction (shrinking)
    delay: torch.Tensor | None = None  # effective delay flag (adaptive)


def _check_use_kernel(use_kernel, device: torch.device) -> None:
    """``use_kernel`` ∈ {"auto", True, False}.  ``False`` (the plain
    engines) is refused on the card, where a CUDA tensor never reaches a
    plain engine.  On the 1-D mesh the block engines decide by device
    alone — the kernel for CUDA tensors, its plain version for CPU
    tensors — so every other value gives the same solve; on the 2-D mesh
    ``_fused_2d`` picks the engine."""
    if use_kernel not in ("auto", True, False):
        raise ValueError(f"use_kernel must be 'auto', True or False, got "
                         f"{use_kernel!r}")
    if not use_kernel and device.type == "cuda":
        raise ValueError(
            "use_kernel=False selects the plain engines, which are the CPU "
            "path; on CUDA the solver runs the kernels")


def _fused_2d(use_kernel, device: torch.device) -> bool:
    """The 2-D engine: fused (B4 → sum → B5) for True, and for "auto"
    on the card only."""
    return use_kernel is True or (use_kernel == "auto"
                                  and device.type == "cuda")


def _shard_sum(dw, pods: int = 1):
    """The psum over ``data``: each task's p shards' Δw (K, p, *w)
    summed in shard order, (K, *w); with ``pods`` P > 1 the P·p shards
    are P pods' and each pod's p shards sum apart, (K, P, *w) — the
    reference's pod-local round psum."""
    if pods > 1:
        K, rest = dw.shape[0], dw.shape[2:]
        return _shard_sum(dw.reshape(K * pods, -1, *rest)).view(K, pods,
                                                                 *rest)
    return dw[:, 0] if dw.shape[1] == 1 else dw.sum(1)


def _per_shard(w):
    """Each task's one w (K, *w) as a w a shard (K, 1, *w)."""
    return w[:, None]


def _task_rows(t, k):
    """Task k's row of a (K, …) operand, or the shared operand itself
    (None, or one row for every task)."""
    return t if t is None or t.dim() == 1 else t[k]


def _block_update_1d(loss, ell: bool, n_loc: int = 0, Y=None):
    """The round's block engine, the counterpart of the reference's
    ``_local_block_update_ell`` / ``_local_block_update`` under its task
    vmap: the B1 or B2 wrapper over K tasks of p shards — α (K, n_pad),
    w_eff (K, *w) or (K, p, *w), ids (p, B) or (K, p, B), the labels
    ``Y`` (K, n_pad) or None (pre-folded rows) — returning (updated α,
    the pairs' Δw (K, p, *w)).  ``act`` ((n_pad,) or (K, n_pad))
    freezes shrunk rows.  A w_eff (K, P, *w) for 1 < P < p is a view a
    pod: the p shards are P pods'."""

    def block_update(X_loc, sq_loc, alpha, w_eff, idx_block, act=None):
        if ell:
            cols_loc, vals_loc = X_loc
            return dcd_ell_block_update(cols_loc, vals_loc, sq_loc, alpha,
                                        w_eff, idx_block, loss=loss,
                                        active=act, y=Y, n_loc=n_loc)
        return dcd_block_update(X_loc, sq_loc, alpha, w_eff, idx_block,
                                loss=loss, active=act, y=Y, n_loc=n_loc)

    return block_update


def _local_block_update_feature(cols, vals, sq_norms, alpha, w, idx_block,
                                loss, act=None, y=None):
    """The unfused 2-D engine (the reference's
    ``_local_block_update_feature``) for one data shard of one task: B
    sequential updates of the row ids ``idx_block``, each summing the m
    shards' O(k_loc) partial dots — the reference's per-update psum over
    ``model`` — and scattering into every shard's own slice.
    ``sq_norms`` are the full row norms, so δ is one value for all
    shards; ``act`` (0/1) freezes shrunk rows; ``y`` folds the task's
    labels on read.  Returns (updated α, Δw over the (m, d_loc + 1)
    slices)."""
    alpha, w_cur = alpha.clone(), w.clone()
    d1 = w.shape[1]
    w_flat = w_cur.view(-1)
    for i in idx_block.tolist():
        ids = flat_shard_ids(cols[i], d1)  # (m, k)
        v = vals[i]
        wx = torch.sum(torch.sum(w_flat[ids] * v, dim=1))
        if y is not None:
            wx = y[i] * wx
        delta = loss.delta(alpha[i], wx, sq_norms[i])
        if act is not None:
            delta = torch.where(act[i] > 0.0, delta, 0.0)
        alpha[i] = alpha[i] + delta
        dscale = delta if y is None else delta * y[i]
        w_flat.index_add_(0, ids.reshape(-1), (dscale * v).reshape(-1))
    return alpha, w_cur - w


def _block_update_2d(loss, fused: bool, workspace, n_loc: int = 0, Y=None):
    """The 2-D block engine over K tasks of p data shards (eager
    composition; the overlapped round drives the split phases directly):
    α (K, n_pad), w_eff (K, m, d_loc + 1) or (K, p, m, d_loc + 1), ids
    (p, B) or (K, p, B); a w_eff (K, P, m, d_loc + 1) for 1 < P < p is
    a view a pod.  Returns (updated α, the pairs' Δw (K, p, m,
    d_loc + 1)).  The unfused engine runs the tasks, then the shards, in
    order."""

    def block_update(cols, vals, sq_norms, alpha, w_eff, idx_block,
                     act=None):
        if fused:
            return dcd_feature_block_update(cols, vals, sq_norms, alpha,
                                            w_eff, idx_block, loss=loss,
                                            active=act, y=Y,
                                            workspace=workspace,
                                            n_loc=n_loc)
        alphas, dws = [], []
        for k in range(alpha.shape[0]):
            a_k, dw_k = alpha[k], []
            ids = idx_block[k] if idx_block.dim() == 3 else idx_block
            for s in range(ids.shape[0]):
                w_s = (w_eff[k, pod_row(s, ids.shape[0], w_eff[k])]
                       if w_eff.dim() == 4 else w_eff[k])
                a_k, dw = _local_block_update_feature(
                    cols, vals, sq_norms, a_k, w_s,
                    ids[s].long() + s * n_loc, loss, _task_rows(act, k),
                    _task_rows(Y, k))
                dw_k.append(dw)
            alphas.append(a_k)
            dws.append(torch.stack(dw_k))
        return torch.stack(alphas), torch.stack(dws)

    return block_update


def _n_blocks(n_loc: int, block_size: int) -> int:
    """Blocks per shard per epoch — rounded UP so an epoch is a full
    pass; the tail block revisits early rows of the draw."""
    return max(-(-n_loc // block_size), 1)


def _device_block_perm(sub, my: int, p: int, n_loc: int, n_rows: int,
                       n_blocks: int, block_size: int):
    """Shard ``my``'s masked block permutation for one epoch, from the
    epoch subkey ``sub``: the shard owns global rows [my·n_loc,
    (my+1)·n_loc), of which the first v = clip(n_rows − my·n_loc, 1,
    n_loc) are real (a shard of padding only draws its row 0, a zero row
    whose update cannot move w)."""
    v = min(max(n_rows - my * n_loc, 1), n_loc)
    return _device_block_perm_v(sub, my, p, n_loc, v, n_blocks, block_size)


def _device_block_perm_v(sub, my: int, p: int, n_loc: int, v: int,
                         n_blocks: int, block_size: int):
    """The draw core, the reference's key chain step for step:
    ``split(sub, p)``, a permutation of n_loc under this shard's key,
    the invalid ids (≥ v) stable-sorted to the back, cycled through the
    valid prefix over n_blocks·B slots.  Returns (n_blocks, B) int32."""
    m = n_blocks * block_size
    keys = prng.split(sub, p)
    perm = prng.permutation(keys[my], n_loc)
    order = torch.argsort((perm >= v).to(torch.int8), stable=True)
    sel = perm[order][torch.arange(m, device=perm.device) % v]
    return sel.reshape(n_blocks, block_size).to(torch.int32)


def _device_block_perm_masked(sub, my: int, p: int, n_loc: int,
                              n_blocks: int, block_size: int, act, rp):
    """``_device_block_perm`` over an arbitrary active row set — the
    repacked epoch's draw, for K tasks at once.  ``act`` is the shard's
    (K, n_loc) bool mask, a row a task (already ANDed with row
    validity), ``rp`` the (K,) repack flags.  ``active_row_remap``
    compacts each task's active rows to the front; the draw permutes
    [0, count) through the same key chain — one permutation for every
    task, as the reference's tasks share a key — and maps back.  Slots
    past the count cycle the drawn sequence when the task's ``rp`` is
    off (with ``act`` the valid prefix this is the plain draw bit for
    bit) and point at the inactive rows, δ-gated no-ops, when it is on
    (a fully active shard cycles).  Integer ops only: a task's ids are
    those of its own binary draw.  Returns (K, n_blocks, B) int32."""
    m = n_blocks * block_size
    keys = prng.split(sub, p)
    ids, cnt = active_row_remap(act)  # a row a task
    v = torch.clamp(cnt, min=1)[:, None]  # an all-frozen shard: a no-op
    perm = prng.permutation(keys[my], n_loc)
    order = torch.argsort((perm[None] >= v).to(torch.int8), dim=1,
                          stable=True)
    pos = torch.arange(m, device=perm.device)[None]
    cyc = perm[order].gather(1, (pos % v).long())
    n_inact = (n_loc - cnt)[:, None]
    noop = cnt[:, None] + pos % torch.clamp(n_inact, min=1)
    fill = torch.where(rp[:, None] & (n_inact > 0), noop, cyc)
    sel = ids.long().gather(1, torch.where(pos < v, cyc, fill).long())
    return sel.reshape(-1, n_blocks, block_size).to(torch.int32)


def _scan_rounds(block_update, alpha_loc, w_loc, dw_prev, blocks_loc,
                 delay_rounds: int, pods: int = 1):
    """The round structure: per round the block engine runs against the
    (possibly stale) effective w, and its Δw — each task's summed over
    the ``data`` shards — is applied now (atomic) or one round late
    (``delay_rounds``), the reference's exact bookkeeping.
    ``block_update(alpha, w_eff, idx_block)`` closes over the shards;
    α, w and Δw carry the leading task dimension K, and with ``pods``
    P > 1 a pod dimension after it (w and Δw (K, P, *w): each pod's
    rounds read and update its own w, the psum pod-local)."""
    for idx_block in blocks_loc:
        w_eff = w_loc + dw_prev if delay_rounds > 0 else w_loc
        alpha_loc, dw_loc = block_update(alpha_loc, w_eff, idx_block)
        dw_all = _shard_sum(dw_loc, pods)
        if delay_rounds > 0:
            w_loc, dw_prev = w_loc + dw_prev, dw_all
        else:
            w_loc = w_loc + dw_all
    return alpha_loc, w_loc, dw_prev


def _scan_rounds_dyn(block_update, alpha, w, dw_prev, dw_own, blocks, act,
                     n_run: int, delay_flag, runs=None, n_all: int = 0):
    """The self-tuning round scan (the reference's ``_scan_rounds_dyn``):
    ``_scan_rounds`` with (a) the active mask ``act`` gating every δ,
    (b) only the first ``n_run`` rounds run (the repacked block count,
    the largest of the tasks'), and (c) the delayed mode a runtime flag
    with real stale reads: while a task's ``delay_flag`` is set its
    round's Δw sum stays in flight for one round and the next round
    reads w with its own shard's last-round updates (``dw_own``,
    (K, p, *w)) but not its peers', τ ≈ 2·B·(p−1).  ``delay_flag`` is a
    host int (fixed) or a (K,) device int32 tensor (the tasks' adaptive
    latches, read without a sync).  ``runs`` is each task's own round
    count on the device, and rounds from ``n_all`` on (the fewest any
    task runs) keep a task past its count where it was — the
    reference's ``cond``-skipped round, a select under its task vmap.
    Returns (α, w, Δw in flight, dw_own)."""
    fixed = not torch.is_tensor(delay_flag)
    on = delay_flag > 0
    if not fixed:
        on_w = on.view(-1, *(1,) * (w.dim() - 1))  # (K, 1, …)
        on_o = on_w[:, None]
    for r, idx_block in enumerate(blocks[:n_run]):
        if fixed:  # never delayed: dw_prev stays 0, w_eff is w
            w_eff = _per_shard(w) + dw_own if on else w
        else:
            w_eff = _per_shard(w) + torch.where(on_o, dw_own,
                                                _per_shard(dw_prev))
        state = (alpha, w, dw_prev, dw_own)
        alpha, dw_loc = block_update(alpha, w_eff, idx_block, act)
        dw_all = _shard_sum(dw_loc)
        if fixed and on:
            w, dw_prev, dw_own = w + dw_prev, dw_all, dw_loc
        elif fixed:  # never delayed: nothing is in flight
            w = w + dw_all
        else:
            w = w + dw_prev + torch.where(on_w, 0.0, dw_all)
            dw_prev = torch.where(on_w, dw_all, 0.0)
            dw_own = torch.where(on_o, dw_loc, 0.0)
        if runs is not None and r >= n_all:
            keep = r < runs  # (K,): the tasks still within their count
            alpha, w, dw_prev, dw_own = (
                torch.where(keep.view(-1, *(1,) * (new.dim() - 1)), new,
                            old)
                for new, old in zip((alpha, w, dw_prev, dw_own), state))
    return alpha, w, dw_prev, dw_own


def _overlap_round_fns(cols, vals, sq_norms, loss, n_loc: int = 0, Y=None):
    """The three split phases of the fused 2-D block round, bound to the
    resident slices (``repro_torch.kernels.ops`` entry points), over K
    tasks of the (p, B) shard-local ids.  B4 (``gram_fn``) fills the
    workspace it is given with the block's buckets, which B5
    (``update_fn``) of the same block reads."""

    def gram_fn(w_ref, idx, workspace):
        return dcd_feature_gram(cols, vals, w_ref, idx, workspace=workspace,
                                n_loc=n_loc, tasks=True)

    def corr_fn(dvec, idx):
        return dcd_feature_base_correction(cols, vals, dvec, idx,
                                           n_loc=n_loc, tasks=True)

    def update_fn(alpha, w_ref, idx, base, gram, workspace, act=None):
        return dcd_feature_update(cols, vals, sq_norms, alpha, w_ref, idx,
                                  base, gram, loss=loss, active=act, y=Y,
                                  workspace=workspace, n_loc=n_loc)

    return gram_fn, corr_fn, update_fn


def _scan_rounds_overlap(gram_fn, corr_fn, update_fn, alpha, w, dw_prev,
                         blocks, inflight, next0, workspaces, act=None):
    """``_scan_rounds`` for the fused 2-D engine with the round
    double-buffered: entering round t the carry holds block t's summed
    (base⁰_t, gram_t), one per data shard, whose base was taken against
    W_t, the primal without the round's in-flight aggregate D_t (round
    t−1's Δw sum), and the workspace B4 filled for block t.  The Gram
    never depends on w and the base is repaired exactly, base_t = base⁰_t
    + D_tᵀx, while block t+1's (base, Gram) is formed against the
    already known W_{t+1} = W_t + D_t — into the other of the two
    ``workspaces``, so B5 of block t still reads block t's buckets.  The
    bookkeeping is the delayed branch of ``_scan_rounds``
    (``delay_rounds ≥ 1``; the caller flushes the last aggregate).
    ``inflight`` is blocks[0]'s (base⁰, Gram, workspace) against the
    entering w, ``next0`` the first block of the following epoch, ``act``
    the shrinking mask B5 gates with; returns (α, w, Δw, the aggregate
    issued for ``next0``)."""
    nxt = list(blocks[1:]) + [next0]
    extra = () if act is None else (act,)
    for idx, idx_next in zip(blocks, nxt):
        base0, gram, ws = inflight
        ws_next = workspaces[1] if ws is workspaces[0] else workspaces[0]
        w_next = w + dw_prev  # W_{t+1}: known before D_{t+1} lands
        inflight_next = (*gram_fn(w_next, idx_next, ws_next), ws_next)
        base = base0 + corr_fn(dw_prev, idx)
        alpha, w_upd = update_fn(alpha, w_next, idx, base, gram, ws, *extra)
        w, dw_prev, inflight = (w_next,
                                _shard_sum(w_upd - _per_shard(w_next)),
                                inflight_next)
    return alpha, w, dw_prev, inflight


def _gap_slots(epochs: int, gap_every: int) -> int:
    """How many duality gaps the solve records — every ``gap_every``-th
    epoch plus the final one."""
    gap_every = max(int(gap_every), 1)
    return sum(1 for e in range(epochs)
               if (e + 1) % gap_every == 0 or e == epochs - 1)


def _make_gap_1d(loss, X_loc, ell: bool, d_run: int, segments=None):
    """The duality gap and the backward-error metric over the rows of
    ``X_loc`` (the real rows: where the padding is the layout's tail the
    caller hands the first n rows and α[:n]; a pod layout's real rows
    are the runs ``segments``, (start, _, count) each, of the padded
    ``X_loc``, and α the runs concatenated): gap(α) = ‖w(α)‖² + Σ_i
    [ℓ(w(α)ᵀx_i) + ℓ*(−α_i)] and ‖w(α) − ŵ‖ against the maintained
    primal view ``w_view`` (ε = w̄ − ŵ of ``core/backward_error.py``).
    ``y`` folds one task's labels on read: w(α) = Σ α_i·y_i·x_i and the
    margin y_i·w(α)ᵀx_i, while ℓ*(−α) reads α.  Returns device scalars:
    no host sync."""
    rows = X_loc[0] if ell else X_loc
    runs = segments or ((0, 0, rows.shape[0]),)
    lens = [c for _, _, c in runs]
    if ell:
        parts = [(X_loc[0][a:a + c], X_loc[1][a:a + c]) for a, _, c in runs]

        def rmv(a):
            wa = torch.zeros((d_run,), dtype=torch.float32,
                             device=a.device)
            for (cols_loc, vals_loc), ap in zip(parts, a.split(lens)):
                wa.index_add_(0, cols_loc.reshape(-1).long(),
                              (ap[:, None] * vals_loc).reshape(-1))
            return wa

        def mv(wa):
            z = [torch.sum(wa[c.long()] * v, dim=1) for c, v in parts]
            return z[0] if len(z) == 1 else torch.cat(z)
    else:
        parts = [X_loc[a:a + c] for a, _, c in runs]

        def rmv(a):
            wa = None
            for X_p, ap in zip(parts, a.split(lens)):
                wa = X_p.T @ ap if wa is None else wa + X_p.T @ ap
            return wa

        def mv(wa):
            z = [X_p @ wa for X_p in parts]
            return z[0] if len(z) == 1 else torch.cat(z)

    def gap(alpha_loc, w_view, y=None):
        wa = rmv(alpha_loc if y is None else alpha_loc * y)
        z = mv(wa)
        if y is not None:
            z = y * z
        s = torch.sum(loss.primal_loss(z) + loss.conj(alpha_loc))
        e = wa - w_view  # the dummy slot is 0 in both
        return torch.dot(wa, wa) + s, torch.sqrt(torch.dot(e, e))

    return gap


def _row_dots_2d(cols, vals, w_view, rows: int):
    """wᵀx_i of every row of the feature shards, each the sum of the
    shards' partial dots, in row chunks of ``rows`` rows (no (n, m,
    k_loc) temporary at webspam's size)."""
    d1 = w_view.shape[1]
    flat = w_view.reshape(-1)
    return torch.cat([
        torch.sum(torch.sum(flat[flat_shard_ids(c, d1)] * v, dim=2), dim=1)
        for c, v in zip(cols.split(rows), vals.split(rows))])


def _chunk_rows(cols, chunk_elems: int) -> int:
    n, m, k = cols.shape
    return max(1, chunk_elems // (m * k))


def _make_gap_2d(loss, cols, vals, chunk_elems: int = 1 << 26,
                 segments=None):
    """``_make_gap_1d`` for the feature shards: w(α) stays one slice per
    shard, each row's dot and ‖w(α)‖² are sums of the shards' partials
    (the reference's psums over ``model``).  Works in row chunks of about
    ``chunk_elems`` entries, so no (n, m, k_loc) temporary is formed,
    and scatters only real entries (padding lanes would all add 0 into
    the m dummy slots).  ``y`` folds one task's labels on read.
    ``segments`` are a pod layout's runs of real rows, as for
    ``_make_gap_1d``."""
    m = cols.shape[1]
    rows = _chunk_rows(cols, chunk_elems)
    runs = segments or ((0, 0, cols.shape[0]),)
    parts = [(cols[a:a + c], vals[a:a + c]) for a, _, c in runs]

    def gap(alpha, w_view, y=None):
        d1 = w_view.shape[1]
        ay = alpha if y is None else alpha * y
        wa = torch.zeros((m * d1,), dtype=torch.float32, device=alpha.device)
        for (cp, vp), ap in zip(parts, ay.split([c for _, _, c in runs])):
            for c, v, a in zip(cp.split(rows), vp.split(rows),
                               ap.split(rows)):
                real = c < d1 - 1
                wa.index_add_(0, flat_shard_ids(c, d1)[real],
                              (a[:, None, None] * v)[real])
        wa = wa.view(m, d1)
        z = [_row_dots_2d(cp, vp, wa, rows) for cp, vp in parts]
        z = z[0] if len(z) == 1 else torch.cat(z)
        if y is not None:
            z = y * z
        s = torch.sum(loss.primal_loss(z) + loss.conj(alpha))
        e = wa - w_view  # the dummy slots are 0 in both
        return (torch.sum(torch.sum(wa * wa, dim=1)) + s,
                torch.sqrt(torch.sum(torch.sum(e * e, dim=1))))

    return gap


def _task_gaps(gap, alpha, w_view, Y, segs):
    """Each task's (gap, ‖w(α) − ŵ‖) over the real rows (the layout's
    runs ``segs``), task by task with its labels folded on read: two
    (K,) device tensors."""
    out = [gap(_real_rows(alpha[k], segs), w_view[k],
               None if Y is None else _real_rows(Y[k], segs))
           for k in range(alpha.shape[0])]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


def _make_shrink(setup, chunk_elems: int = 1 << 26):
    """The active-mask recompute (the reference's ``_make_shrink_1d`` /
    ``_2d``), task by task: fresh projected gradients from (α, w_view) —
    wᵀx_i by the layout's own matvec (on the 2-D mesh the sum of the
    shards' partial dots, in row chunks), y_i·wᵀx_i with the task's
    labels — through ``active_mask_from_w``, ANDed with row validity so
    padding rows never count as active.  Returns a (K, n_pad) bool
    mask, a row a task, and the (n_pad,) validity."""
    valid = torch.arange(setup.n_pad, device=setup.device) < setup.n
    if setup.two_d:
        cols, vals = setup.X
        rows = _chunk_rows(cols, chunk_elems)

        def mv(wv):
            return _row_dots_2d(cols, vals, wv, rows)
    elif setup.ell:
        cols, vals = setup.X

        def mv(wv):
            return torch.sum(wv[cols.long()] * vals, dim=1)
    else:
        def mv(wv):
            return setup.X @ wv

    def mask_fn(alpha, w_view):
        masks = []
        for k in range(alpha.shape[0]):
            wx = mv(w_view[k])
            if setup.Y is not None:
                wx = setup.Y[k] * wx
            masks.append(active_mask_from_w(setup.loss, alpha[k], wx,
                                            setup.shrink_tol) & valid)
        return torch.stack(masks)

    return mask_fn, valid


class SolverSetup(NamedTuple):
    """The resolved and placed half of a solve: knobs, sizes and the
    device-resident, row-padded dataset (n_pad = p·n_loc rows, shard s
    the rows [s·n_loc, (s+1)·n_loc), the padding the tail — on a pod
    mesh each pod's p / P shards with their own padded tail, the real
    rows the runs ``segs``), and for a multi-task solve its K and the
    placed (K, n_pad) labels."""

    loss: object
    n: int
    d: int
    n_loc: int
    n_blocks: int
    block_size: int
    w_shape: tuple  # (d+1,) ELL / (d,) dense on 1-D; (m, d_loc+1) on 2-D
    ell: bool
    X: object  # (cols, vals) — (n_pad, k) or (n_pad, m, k_loc) — or dense
    sq_norms: torch.Tensor
    delay_rounds: int
    gap_every: int
    record: bool
    seed: int
    device: torch.device
    two_d: bool = False
    m: int = 1  # feature shards (2-D)
    d_loc: int = 0  # features per shard (2-D)
    fused: bool = False  # the 2-D engine
    overlap: bool = False  # the overlapped 2-D round
    p: int = 1  # data shards
    tuning: SelfTuning = SelfTuning(0, False, False, False)
    shrink_tol: float = 1e-3
    repack_threshold: float = 0.5
    adaptive_ratio: float = 0.95
    n_tasks: int = 0  # multi-task K (0 = binary)
    Y: object = None  # placed (K, n_pad) ±1 labels (None = binary)
    pod_on: bool = False  # a 'pod' mesh axis: the Hybrid-DCA outer round
    pods: int = 1  # P: p is P pods of p / P data shards
    pod_delay_rounds: int = 0
    segs: tuple = ()  # the real rows' runs (start, user row, count)

    @property
    def n_pad(self) -> int:
        return self.p * self.n_loc

    @property
    def K(self) -> int:
        """The solve's task count: its state's leading dimension."""
        return max(self.n_tasks, 1)


def _resolve_mesh(mesh, mesh_axes) -> SolverMesh:
    """The solver's mesh: ``mesh`` if given, else one built from
    ``mesh_axes`` with every axis of size 1.  A legacy ``("model",)`` mesh
    maps to (data = 1, model = m)."""
    if mesh is None:
        axes = tuple(mesh_axes)
        mesh = SolverMesh(axes, (1,) * len(axes))
    names = tuple(mesh.axis_names)
    if "model" in names and "data" not in names:
        mesh = solver_mesh_2d(data=1, model=mesh.shape["model"])
    return mesh


def _pad_rows(t, n_pad: int, fill):
    """``t`` with its rows padded to ``n_pad`` by ``fill`` (no copy when
    nothing is padded)."""
    extra = n_pad - t.shape[0]
    if extra == 0:
        return t
    return torch.cat([t, torch.full((extra, *t.shape[1:]), fill,
                                    dtype=t.dtype, device=t.device)])


def _pod_segments(n: int, pods: int, p_pod: int, n_loc: int) -> tuple:
    """The real rows of the pod layout as runs (start, user row, count):
    pod k's rows [k·n_pod_loc, k·n_pod_loc + c_k) of the user's order
    (n_pod_loc = ⌈n/P⌉) start at k·p_pod·n_loc of the padded layout, the
    rest of the pod's p_pod·n_loc slots padding — the layout of a gather
    through ``pod_row_layout``'s rowmap.  Adjacent runs merge: one run
    (0, 0, n), padding only at the tail, when no pod pads inside (P = 1,
    or p_pod·n_loc = n_pod_loc)."""
    n_pod_loc = max(-(-n // pods), 1)
    runs = []
    for k in range(pods):
        c = min(max(n - k * n_pod_loc, 0), n_pod_loc)
        start, src = k * p_pod * n_loc, k * n_pod_loc
        if c and runs and runs[-1][0] + runs[-1][2] == start:
            runs[-1] = (runs[-1][0], runs[-1][1], runs[-1][2] + c)
        elif c:
            runs.append((start, src, c))
    return tuple(runs)


def _place_rows(t, n_pad: int, segs, fill):
    """``t``'s n rows placed into the ``n_pad`` slots of the layout whose
    real rows are the runs ``segs``, every other slot ``fill`` (no copy
    when the layout is ``t`` padded at its tail and nothing is padded)."""
    if len(segs) == 1 and segs[0][:2] == (0, 0):
        return _pad_rows(t, n_pad, fill)
    out = torch.full((n_pad, *t.shape[1:]), fill, dtype=t.dtype,
                     device=t.device)
    for start, src, c in segs:
        out[start:start + c] = t[src:src + c]
    return out


def _real_rows(t, segs):
    """The real rows of a padded (…, n_pad) tensor in the user's order:
    its last dimension's runs ``segs`` (a view where there is one run)."""
    if len(segs) == 1:
        start, _, c = segs[0]
        return t[..., start:start + c]
    return torch.cat([t[..., a:a + c] for a, _, c in segs], dim=-1)


def _place_labels(y, *, n: int, n_pad: int, device, segs):
    """The (K, n) ±1 label matrix placed into the solve's row layout, the
    padding rows +1 (inert: their rows are zero and outside every sum;
    the fold only has to stay finite).  Returns (K, the (K, n_pad)
    float32 labels on ``device``)."""
    Y = (y.to(device, torch.float32) if torch.is_tensor(y)
         else torch.tensor(np.asarray(y, np.float32), device=device))
    if Y.dim() != 2 or Y.shape[1] != n:
        raise ValueError(f"label matrix has shape {tuple(Y.shape)} for "
                         f"{n} rows")
    K = int(Y.shape[0])
    return K, _place_rows(Y.T, n_pad, segs, 1.0).T.contiguous()


def prepare_solver(X_host, loss, *, mesh=None, mesh_axes: tuple = ("data",),
                   y=None, block_size: int = 64, delay_rounds: int = 0,
                   pod_delay_rounds: int = 0, seed: int = 0,
                   record: bool = True, use_kernel="auto",
                   gap_every: int = 1, pipeline: bool = True,
                   overlap="auto", shrink_every: int = 0,
                   shrink_tol: float = 1e-3, repack="auto",
                   repack_threshold: float = 0.5, adaptive: bool = False,
                   adaptive_ratio: float = 0.95,
                   device=None) -> SolverSetup:
    """Resolve the knobs, size the blocks and place the dataset on the
    device — the reference's ``prepare_solver`` without its lane
    padding: rows pad to n_pad = p·n_loc with zero rows (q = 1), which
    at p | n is no padding.  On a 2-D mesh a dense X converts to ELL and
    is split into ``FeatureShardedEll`` slices on the device.  It takes
    every keyword of the reference's: ``y`` is the (K, n) multi-task
    label matrix (admitted by ``task_axis_policy``, as a ``task`` mesh
    axis is, and placed with its padding rows at +1); a ``pod`` mesh
    axis and ``pod_delay_rounds`` are admitted by ``pod_merge_policy``
    (each pod's rows padded to its own p·n_loc slots, ⌈n/P⌉ rows a pod,
    ``_pod_segments``; ``overlap="auto"`` resolves off);
    ``pipeline=False`` raises ``NotImplementedError``
    (``_reject_unported``), and the self-tuning knobs are validated by
    ``resolve_self_tuning``."""
    mesh = _resolve_mesh(mesh, mesh_axes)
    pod_on = "pod" in mesh.axis_names
    if pod_on:
        pod_merge_policy(pod_delay_rounds, n_pods=mesh.shape["pod"],
                         pipeline=pipeline, record=record,
                         shrink_every=shrink_every, adaptive=adaptive,
                         overlap=overlap)
    elif pod_delay_rounds:
        raise ValueError(
            "pod_delay_rounds needs a mesh with a 'pod' axis")
    if y is not None:
        task_axis_policy(torch.as_tensor(y).shape[0], mesh=mesh,
                         pipeline=pipeline)
    elif "task" in mesh.axis_names:
        raise ValueError(
            "a 'task' mesh axis needs a (K, n) label matrix y "
            "(DESIGN.md §16)")
    _reject_unported(mesh=mesh, pipeline=pipeline)
    dev = resolve_device(device)
    _check_use_kernel(use_kernel, dev)
    if int(block_size) < 1:
        raise ValueError(f"block_size must be ≥ 1, got {block_size}")
    if int(delay_rounds) < 0:
        raise ValueError(f"delay_rounds must be ≥ 0, got {delay_rounds}")
    two_d = "model" in mesh.axis_names
    p = dp_size(mesh)
    pods = mesh.shape["pod"] if pod_on else 1
    ell = isinstance(X_host, EllMatrix)
    fused = two_d and _fused_2d(use_kernel, dev)
    overlap_on = pipeline_overlap(overlap, two_d=two_d, fused=fused,
                                  delay_rounds=int(delay_rounds))
    if pod_on:
        # pod_merge_policy rejected an explicit overlap=True; "auto"
        # resolves off: the in-flight (base, Gram) is not valid under the
        # merge-rescaled outer schedule
        overlap_on = False
    tuning = resolve_self_tuning(shrink_every, repack, adaptive,
                                 overlap_knob=overlap, overlap_on=overlap_on,
                                 pipeline=pipeline, record=record)
    if two_d:
        ell_m = X_host.to(dev) if ell else dense_to_ell(X_host, device=dev)
        n = ell_m.n_rows
    else:
        n = X_host.n_rows if ell else len(X_host)
    if n < 1:
        raise ValueError("X has no rows")
    # ceil twice on a pod mesh: each pod's contiguous rows carry their own
    # padded tail, then subdivide over its p / P data shards
    n_loc = -(-max(-(-n // pods), 1) // (p // pods))
    segs = _pod_segments(n, pods, p // pods, n_loc)
    n_pad = p * n_loc
    if two_d:
        d = ell_m.n_features
        m = mesh.shape["model"]
        fse = ell_column_split(
            EllMatrix(ell_m.indices.to(torch.int32),
                      ell_m.values.to(torch.float32), d), m)
        del ell_m
        X = (_place_rows(fse.indices, n_pad, segs, fse.d_loc),
             _place_rows(fse.values, n_pad, segs, 0.0))
        sq_norms = _place_rows(fse.row_sq_norms(), n_pad, segs, 1.0)
        w_shape, extra = (m, fse.d_loc + 1), dict(m=m, d_loc=fse.d_loc)
    elif ell:
        d = X_host.n_features
        cols = X_host.indices.to(dev, torch.int32).contiguous()
        vals = X_host.values.to(dev, torch.float32).contiguous()
        sq_norms = _place_rows(torch.sum(vals * vals, dim=1), n_pad, segs,
                               1.0)
        X = (_place_rows(cols, n_pad, segs, d),
             _place_rows(vals, n_pad, segs, 0.0))
        w_shape, extra = (d + 1,), {}
    else:
        X = torch.as_tensor(X_host, dtype=torch.float32,
                            device=dev).contiguous()
        d = X.shape[1]
        sq_norms = _place_rows(torch.sum(X * X, dim=1), n_pad, segs, 1.0)
        X = _place_rows(X, n_pad, segs, 0.0)
        w_shape, extra = (d,), {}
    if ell or two_d:
        cols = X[0]
        lim = extra.get("d_loc", d)
        if not (0 <= int(cols.min()) and int(cols.max()) <= lim):
            raise ValueError(f"ELL column ids must lie in [0, {lim}]")
    if y is not None:
        extra["n_tasks"], extra["Y"] = _place_labels(y, n=n, n_pad=n_pad,
                                                     device=dev, segs=segs)
    return SolverSetup(
        loss=loss, n=n, d=d, n_loc=n_loc,
        n_blocks=_n_blocks(n_loc, block_size),
        block_size=int(block_size), w_shape=w_shape, ell=ell or two_d, X=X,
        sq_norms=sq_norms, delay_rounds=int(delay_rounds),
        gap_every=max(int(gap_every), 1), record=record, seed=int(seed),
        device=dev, two_d=two_d, fused=fused, overlap=tuning.overlap, p=p,
        tuning=tuning, shrink_tol=float(shrink_tol),
        repack_threshold=float(repack_threshold),
        adaptive_ratio=float(adaptive_ratio), pod_on=pod_on, pods=pods,
        pod_delay_rounds=int(pod_delay_rounds), segs=segs, **extra)


def _init_alpha_w(setup: SolverSetup, alpha0=None, w0=None):
    """(α (K, n_pad), w (K, *w_shape)) for a solve — zeros, or a warm
    start from carried state: a (K, n')/(K, d') stack on a multi-task
    solve, an (n',)/(d',) one on a binary solve (K = 1).  A carried
    state *shorter* than n/d is the streaming-append warm start: old
    coordinates keep their values, new ones start at 0.  On a pod mesh
    α0 lands in each pod's rows, whatever pod count it was carried
    from; on a 2-D mesh each task's w0 is re-blocked onto the shards'
    slices."""
    dev, K = setup.device, setup.K
    alpha = torch.zeros((K, setup.n_pad), dtype=torch.float32, device=dev)
    if alpha0 is not None:
        a0 = torch.as_tensor(alpha0, dtype=torch.float32,
                             device=dev).reshape(K, -1)[:, :setup.n]
        for start, src, c in setup.segs:
            c = min(c, max(a0.shape[1] - src, 0))
            alpha[:, start:start + c] = a0[:, src:src + c]
    w = torch.zeros((K, *setup.w_shape), dtype=torch.float32, device=dev)
    if w0 is not None:
        v0 = torch.as_tensor(w0, dtype=torch.float32,
                             device=dev).reshape(K, -1)[:, :setup.d]
        if setup.two_d:
            flat = torch.zeros((K, setup.m * setup.d_loc),
                               dtype=torch.float32, device=dev)
            flat[:, :v0.shape[1]] = v0
            w[:, :, :setup.d_loc] = flat.view(K, setup.m, setup.d_loc)
        else:
            w[:, :v0.shape[1]] = v0
    return alpha, w


def _finalize(setup: SolverSetup, alpha, w, gaps, epochs, eps=None,
              active=None, delay=None):
    """Back to user coordinates: drop the padding rows (a pod layout's
    real rows are its runs ``segs``) and the dummy slot, on a 2-D mesh
    stitch ŵ out of the shards' slices, task by task; a binary solve
    drops the task dimension."""
    K = setup.K
    if setup.two_d:
        w = w[:, :, :setup.d_loc].reshape(K, -1)
    out = (_real_rows(alpha, setup.segs), w[:, :setup.d], gaps, eps, active,
           delay)
    if not setup.n_tasks:
        out = tuple(t[0] for t in out)
    alpha, w, gaps, eps, active, delay = out
    return ShardedResult(alpha, w, gaps, epochs, eps, active, delay)


def _validate_solver_inputs(X_host, y, loss):
    """Fail fast at the solver mouth: a non-positive C, a non-finite
    feature value, or a label outside {−1, +1}.  Returns ``X_host`` with
    the labels folded in (x_i = y_i·ẋ_i) when ``y`` is given."""
    C = getattr(loss, "C", None)
    if C is not None and not float(C) > 0:
        raise ValueError(f"loss.C must be positive, got {C!r}")
    vals = X_host.values if isinstance(X_host, EllMatrix) else X_host
    if not bool(torch.isfinite(torch.as_tensor(vals)).all()):
        raise ValueError("X contains non-finite entries (NaN/Inf)")
    if y is None:
        return X_host
    y = torch.as_tensor(y, dtype=torch.float32).reshape(-1)
    n = (X_host.n_rows if isinstance(X_host, EllMatrix)
         else X_host.shape[0])
    if y.shape[0] != n:
        raise ValueError(f"y has {y.shape[0]} labels for {n} rows")
    if not bool(torch.isfinite(y).all()):
        raise ValueError("y contains non-finite entries (NaN/Inf)")
    if not bool(((y == 1.0) | (y == -1.0)).all()):
        raise ValueError(
            "labels must be in {-1, +1}; the solver folds them into X "
            "as x_i = y_i*x_i")
    if isinstance(X_host, EllMatrix):
        return EllMatrix(X_host.indices,
                         X_host.values * y.to(X_host.device)[:, None],
                         X_host.n_features)
    X = torch.as_tensor(X_host, dtype=torch.float32)
    return X * y.to(X.device)[:, None]


def _validate_multitask_labels(X_host, Y):
    """The multi-task mouth (DESIGN.md §16): a (K, n) ±1 one-vs-rest
    label matrix — validated, not folded into X (each class flips other
    rows, so the engines fold on read).  Returns it as float32."""
    Y = (Y.to(torch.float32) if torch.is_tensor(Y)
         else torch.tensor(np.asarray(Y, np.float32)))
    if Y.dim() != 2 or Y.shape[0] < 1:
        raise ValueError(
            f"multi-task labels must be a (K, n) matrix, got shape "
            f"{tuple(Y.shape)}")
    n = (X_host.n_rows if isinstance(X_host, EllMatrix)
         else X_host.shape[0])
    if Y.shape[1] != n:
        raise ValueError(
            f"label matrix has {Y.shape[1]} columns for {n} rows")
    if not bool(torch.isfinite(Y).all()):
        raise ValueError("Y contains non-finite entries (NaN/Inf)")
    if not bool(((Y == 1.0) | (Y == -1.0)).all()):
        raise ValueError(
            "multi-task labels must be in {-1, +1} (see "
            "repro_torch.data.ovr_labels)")
    return Y


def _reject_unported(*, mesh, pipeline):
    """The reference's knobs outside the ported slices: each raises,
    naming the ROADMAP item that ports it; none is silently ignored."""
    axes = tuple(mesh.axis_names)
    if axes not in (("data",), ("data", "model"), ("task", "data"),
                    ("task", "data", "model"), ("pod", "data"),
                    ("pod", "data", "model")):
        raise ValueError(f"mesh axes {axes}: the solver runs on ('data',) "
                         "or ('data', 'model'), with or without a leading "
                         "'task' or 'pod'")
    if not pipeline:
        raise NotImplementedError(
            "pipeline=False (the per-epoch host driver) is ROADMAP A′.12, "
            "not yet ported")


def _as_blocks(blocks, setup: SolverSetup, epochs: int):
    """An explicit schedule as (epochs, p, n_blocks, B) shard-local
    ids: (epochs, n_blocks, B) row ids at p = 1, (epochs, p, n_blocks,
    B) shard-local ids at p > 1."""
    p = setup.p
    blocks = torch.as_tensor(blocks, dtype=torch.int32, device=setup.device)
    want = (epochs, setup.n_blocks, setup.block_size)
    if p > 1:
        want = (epochs, p) + want[1:]
    if tuple(blocks.shape) != want:
        raise ValueError(f"blocks must have shape {want}, got "
                         f"{tuple(blocks.shape)}")
    lim = setup.n if p == 1 else setup.n_loc
    if not (0 <= int(blocks.min()) and int(blocks.max()) < lim):
        raise ValueError(f"blocks must hold row ids in [0, {lim})")
    if setup.tuning.repack:
        raise ValueError("blocks= is a fixed schedule and repack redraws "
                         "the epochs: pass repack=False")
    return blocks if p > 1 else blocks[:, None]


def _shard_valid(setup: SolverSetup) -> list:
    """Each shard's real-row count for the draw, v = clip(npv − my·n_loc,
    1, n_loc), shard s the data shard my = s mod p_pod of pod k = s /
    p_pod and npv = clip(n − k·⌈n/P⌉, 0, ⌈n/P⌉) its pod's real rows (off
    a pod mesh, P = 1 and npv = n): the reference's draw of each
    device."""
    p_pod = setup.p // setup.pods
    n_pod_loc = max(-(-setup.n // setup.pods), 1)
    out = []
    for s in range(setup.p):
        k, my = divmod(s, p_pod)
        npv = min(max(setup.n - k * n_pod_loc, 0), n_pod_loc)
        out.append(min(max(npv - my * setup.n_loc, 1), setup.n_loc))
    return out


def _block_schedule(setup: SolverSetup, blocks, epochs: int):
    """``draw(e, act=None, rp=None)``: epoch e's (n_blocks, p, B)
    shard-local ids, round-major — from ``blocks`` (an epoch past the
    schedule repeats its last one: only the overlapped round's peek past
    the final epoch asks, and discards it) or through the reference's
    key chain, ``PRNGKey(seed)`` then per epoch ``key, sub =
    split(key)``: one chain for every task, so each task draws its own
    binary solve's blocks.  With the tasks' active masks ``act``
    (K, n_pad) and repack flags ``rp`` (K,) the draw is the masked one
    (``_device_block_perm_masked``), each task's own: (n_blocks, K, p,
    B).  On a pod mesh shard s is the fleet index k·p_pod + my of P·p_pod
    split keys, with its pod's own valid count (``_shard_valid``)."""
    p, n_loc, nb, B = (setup.p, setup.n_loc, setup.n_blocks,
                       setup.block_size)
    if blocks is not None:
        blocks = _as_blocks(blocks, setup, epochs)
        return lambda e, act=None, rp=None: (
            blocks[min(e, epochs - 1)].transpose(0, 1).contiguous())
    key, subs = prng.PRNGKey(setup.seed, device=setup.device), []
    for _ in range(epochs + 1):  # + the peek past the final epoch
        key, sub = prng.split(key)
        subs.append(sub)

    valid = _shard_valid(setup)

    def draw(e, act=None, rp=None):
        if act is None:
            per = [_device_block_perm_v(subs[e], my, p, n_loc, valid[my], nb,
                                        B)
                   for my in range(p)]
            return torch.stack(per, dim=1)  # (n_blocks, p, B)
        acts = act.reshape(act.shape[0], p, n_loc)
        per = [_device_block_perm_masked(subs[e], my, p, n_loc, nb, B,
                                         acts[:, my], rp)
               for my in range(p)]  # each (K, n_blocks, B)
        return torch.stack(per, dim=2).transpose(0, 1).contiguous()

    return draw


def _workspaces(setup: SolverSetup):
    """B4's workspaces on the card: one for the eager round, two that
    alternate for the overlapped one (B4 of block t + 1 runs before B5
    of block t, which reads block t's buckets); None on the CPU."""
    if not (setup.fused and setup.device.type == "cuda"):
        return (None, None)
    return tuple(
        gram_workspace(setup.m, setup.block_size, setup.X[0].shape[2],
                       setup.w_shape[1], setup.device,
                       setup.p, setup.K)
        for _ in range(2 if setup.overlap else 1))


def _epoch_scan(setup: SolverSetup, engine, gap, draw, alpha, w, *,
                epochs: int, overlap_fns=None, workspaces=None):
    """The epoch loop (the reference's ``_epoch_scan`` without pods,
    the watchdog and the fault triple, under its task vmap): draw each
    epoch's blocks, run its rounds — the static ``_scan_rounds``, the
    self-tuning ``_scan_rounds_dyn`` or the overlapped
    ``_scan_rounds_overlap`` (whose in-flight aggregate crosses epochs)
    — and record each task's gap, ‖w(α) − ŵ‖, active fraction and delay
    flag into preallocated (K, slots) device buffers.  Shrinking
    recomputes each task's mask every ``shrink_every`` epochs (the final
    epoch runs unshrunk); repacking draws a task's epoch over its
    compacted active set when its fraction, summed over the shards, is
    below the threshold, and that task runs as many rounds as its
    largest shard's count needs.  The tasks' counts are read on the host
    together, once an epoch, the solve's only sync (counted in
    ``sharded_passcode_solve.host_reads``): the epoch runs the largest,
    a task past its own keeping its state.  The rounds run per epoch are
    kept in ``sharded_passcode_solve.epoch_rounds`` and each task's in
    ``task_rounds``.  The adaptive delay lowers each task's device flag
    at records (one-way), and with shrinking a hard stall turns that
    task's repacking off for good.  On a pod mesh every epoch is the
    Hybrid-DCA outer round (``_pod_epoch``), the adaptive flag the pod
    FIFO's latch.  Returns (α, w, Δw in flight, gaps, eps, active,
    delay)."""
    st, dev, K = setup.tuning, w.device, setup.K
    solve = sharded_passcode_solve
    solve.epoch_rounds, solve.task_rounds = [], []
    n_gaps = _gap_slots(epochs, setup.gap_every) if setup.record else 0
    gaps, epsb, actb, delayb = (torch.zeros((K, n_gaps), dtype=torch.float32,
                                            device=dev) for _ in range(4))
    shrink_on, adaptive = st.shrink_every > 0, st.adaptive
    dyn = (shrink_on or adaptive) and not setup.overlap and not setup.pod_on
    # the delay flag's start: the inner delay, or on a pod mesh whether
    # the pod merge starts delayed
    delay0 = (int(setup.pod_delay_rounds > 0) if setup.pod_on
              else setup.delay_rounds)
    fifo = (torch.zeros((K, setup.pod_delay_rounds, *w.shape[1:]),
                        dtype=torch.float32, device=dev)
            if setup.pod_on else None)
    dw = torch.zeros_like(w)
    dwo = torch.zeros((K, setup.p, *w.shape[1:]), dtype=torch.float32,
                      device=dev) if dyn else None
    if shrink_on:
        mask_fn, valid = _make_shrink(setup)
        act, frac = valid.expand(K, -1), torch.ones((K,), device=dev)
        nrun = torch.full((K,), setup.n_blocks, device=dev)
        rp = torch.zeros((K,), dtype=torch.bool, device=dev)
    if adaptive:
        delay = torch.full((K,), delay0, dtype=torch.int32, device=dev)
        gapprev = torch.full((K,), float("inf"), device=dev)
        rpok = torch.ones((K,), dtype=torch.int32, device=dev)
    inflight = None
    if setup.overlap:
        first = draw(0, act, rp) if shrink_on else draw(0)
        inflight = (*overlap_fns[0](w, first[0], workspaces[0]),
                    workspaces[0])
    slot = 0
    for e in range(epochs):
        final = e == epochs - 1
        n_run, act_run, runs, n_all = setup.n_blocks, None, None, 0
        if shrink_on:
            if e % st.shrink_every == 0:
                act = mask_fn(alpha, w + dw)
                cnt = act.view(K, setup.p, setup.n_loc).sum(2)
                frac = cnt.sum(1).float() / setup.n
                if st.repack:
                    rp = frac < setup.repack_threshold
                    nrun = torch.clamp(
                        -(-cnt.max(1).values // setup.block_size), 1,
                        setup.n_blocks)
            act_run = (valid if final else act).float()
            use_rp = rp & (not final)
            if adaptive:
                use_rp = use_rp & (rpok > 0)
            blocks = draw(e, torch.where(use_rp[:, None], act, valid),
                          use_rp)
            if st.repack:
                # the tasks' round counts, read on the host together: one
                # sync an epoch, and none a round
                runs = torch.where(use_rp, nrun, setup.n_blocks)
                counts = runs.tolist()
                solve.host_reads += 1
                n_run, n_all = max(counts), min(counts)
                solve.task_rounds.append(counts)
        else:
            blocks = draw(e)
        if runs is None:
            solve.task_rounds.append([n_run] * K)
        solve.epoch_rounds.append(n_run)
        delay_flag = delay if adaptive else delay0
        if setup.pod_on:
            alpha, w, fifo = _pod_epoch(setup, engine, alpha, w, blocks,
                                        fifo, delay if adaptive else None)
        elif setup.overlap:
            nxt = (draw(e + 1, valid.expand(K, -1), torch.zeros_like(rp))
                   if shrink_on else draw(e + 1))[0]
            alpha, w, dw, inflight = _scan_rounds_overlap(
                *overlap_fns, alpha, w, dw, blocks, inflight, nxt,
                workspaces, act_run)
        elif dyn:
            alpha, w, dw, dwo = _scan_rounds_dyn(
                engine, alpha, w, dw, dwo, blocks, act_run, n_run,
                delay_flag, runs if n_all < n_run else None, n_all)
        else:
            alpha, w, dw = _scan_rounds(engine, alpha, w, dw, blocks,
                                        setup.delay_rounds)
        if setup.record and ((e + 1) % setup.gap_every == 0 or final):
            g, eps = _task_gaps(gap, alpha, w + dw, setup.Y, setup.segs)
            gaps[:, slot], epsb[:, slot] = g, eps
            actb[:, slot] = frac if shrink_on else 1.0
            delayb[:, slot] = delay_flag
            if adaptive:
                # each task's gap-trend controller, through a one-way latch
                new_flag = adaptive_delay_policy(
                    gapprev, g, improve_ratio=setup.adaptive_ratio)
                delay = torch.minimum(delay_flag, new_flag)
                if shrink_on:
                    # the sticky repack guard keys on a hard stall
                    rpok = rpok * adaptive_delay_policy(gapprev, g)
                gapprev = g
            slot += 1
    if setup.pod_on and setup.pod_delay_rounds:
        dw = fifo.sum(1)  # the merges still in flight, to flush
    return alpha, w, dw, gaps, epsb, actb, delayb


def _pod_epoch(setup: SolverSetup, engine, alpha, w, blocks, fifo,
               latch=None):
    """One Hybrid-DCA outer round (the reference's pod branch of
    ``_epoch_scan``): from the merged snapshot (α₀, w₀) every pod runs
    its epoch's rounds on its own view of w, from a zero Δw carry, and
    flushes its in-flight inner Δw into Δw_pod = (w₁ + Δw_in) − w₀; α
    moves by 1/P of each pod's progress (its rows are its own), and
    g = (1/P)·Σ_pods Δw_pod, summed in pod order, lands now
    (``pod_delay_rounds`` 0) or enters the FIFO (K, delay, *w) while its
    head lands.  ``latch`` (the adaptive delay's (K,) flags) drains a
    task's whole FIFO and merges synchronously once its flag is 0.  At
    P = 1 the merge's scale is 1 and the pod's own α₁ stands (and, at
    delay 0, w₁): the identity without the round trip's rounding.
    Returns (α, w, FIFO)."""
    P, K = setup.pods, alpha.shape[0]
    a0, w0 = alpha, w
    wv = w0 if P == 1 else w0[:, None].expand(K, P, *w0.shape[1:])
    a1, w1, dwi = _scan_rounds(engine, a0, wv.contiguous(),
                               torch.zeros_like(wv), blocks,
                               setup.delay_rounds, P)
    if setup.delay_rounds > 0:
        w1 = w1 + dwi  # the pod's inner rounds end synchronous
    if P == 1:
        alpha, g = a1, w1 - w0
    else:
        scale = 1.0 / P
        alpha = a0 + scale * (a1 - a0)
        g = scale * (w1 - w0[:, None]).sum(1)
    if not setup.pod_delay_rounds:
        return alpha, (w1 if P == 1 else w0 + g), fifo
    w_async = w0 + fifo[:, 0]
    fifo_async = torch.cat([fifo[:, 1:], g[:, None]], 1)
    if latch is None:
        return alpha, w_async, fifo_async
    sync = (latch == 0).view(K, *(1,) * (w0.dim() - 1))
    w = torch.where(sync, w0 + fifo.sum(1) + g, w_async)
    fifo = torch.where(sync[:, None], torch.zeros_like(fifo), fifo_async)
    return alpha, w, fifo


def sharded_passcode_solve(
    X_host,
    loss,
    *,
    mesh=None,
    mesh_axes: tuple = ("data",),
    epochs: int = 10,
    block_size: int = 64,
    delay_rounds: int = 0,
    seed: int = 0,
    record: bool = True,
    gap_every: int = 1,
    alpha0=None,
    w0=None,
    y=None,
    use_kernel="auto",
    device=None,
    blocks=None,
    pod_delay_rounds: int = 0,
    pipeline: bool = True,
    overlap="auto",
    shrink_every: int = 0,
    shrink_tol: float = 1e-3,
    repack="auto",
    repack_threshold: float = 0.5,
    adaptive: bool = False,
    adaptive_ratio: float = 0.95,
) -> ShardedResult:
    """PASSCoDe-Atomic over p ``data`` shards on ``device`` (the card by
    default).  ``X_host``: a dense (n, d) tensor or an ``EllMatrix`` (the
    sparse fast path — per-update work O(k_max) instead of O(d)).

    ``mesh`` (a ``SolverMesh``: ``solver_mesh(n_devices=p)``,
    ``solver_mesh_2d(data=p, model=m)``) or ``mesh_axes`` picks the
    path: ``("data",)`` the 1-D solver over p row shards,
    ``("data", "model")`` the 2-D feature-sharded solver over p × m
    shards (``mesh_axes`` alone means p = m = 1).  ``use_kernel``:
    "auto" (default), True or False — on the 1-D mesh the device alone
    decides (the CUDA kernels on the card, their plain versions on the
    CPU); on the 2-D mesh see the module docstring.  False raises on the
    card.

    ``delay_rounds ≥ 1`` folds each round's Δw in one round late (the
    reference's stale view); ``overlap`` ("auto", True, False)
    double-buffers the fused 2-D round (``pipeline_overlap``).
    ``shrink_every``, ``shrink_tol``, ``repack``, ``repack_threshold``,
    ``adaptive`` and ``adaptive_ratio`` are the reference's self-tuning
    (module docstring).  ``gap_every``: with ``record``, the duality gap,
    ‖w(α) − ŵ‖, the active fraction and the delay flag every that many
    epochs plus the final one, kept on the device.  ``alpha0``/``w0``
    warm-start the solve; ``y`` (n,) ±1 labels are validated and folded
    into X at the mouth.  A (K, n) ±1 ``y`` is the multi-task
    (one-vs-rest) solve of K classes on the unfolded X (module
    docstring): α (K, n), ŵ (K, d) and every record (K, slots) come
    back, and ``alpha0``/``w0`` are (K, …) stacks.  The blocks are
    drawn through the reference's key chain from ``seed``; ``blocks``
    replaces the draw with an explicit schedule ((epochs, n_blocks, B)
    row ids at p = 1, (epochs, p, n_blocks, B) shard-local ids at
    p > 1), the same for every task.  A ``pod`` mesh axis
    (``solver_mesh_3d``, or ``SolverMesh(("pod", "data"), (P, p))``) runs
    the Hybrid-DCA outer round of P pods (module docstring), each
    epoch's merge delayed by ``pod_delay_rounds``; ``alpha0``/``w0``
    carried from any pod count warm-start it.  ``pipeline=False`` raises
    ``NotImplementedError`` naming its ROADMAP item (``prepare_solver``);
    a multi-task solve with ``pipeline=False`` raises the reference's
    ``ValueError``.
    """
    dev = resolve_device(device)
    # a (K, n) label matrix is the multi-task solve: not folded into X
    multitask = y is not None and len(getattr(y, "shape", ())) == 2
    X_host = X_host.to(dev) if isinstance(X_host, EllMatrix) else \
        torch.as_tensor(X_host, dtype=torch.float32, device=dev)
    if multitask:
        y = _validate_multitask_labels(X_host, y)
        X_host = _validate_solver_inputs(X_host, None, loss)
        if not pipeline:
            raise ValueError(
                "a multi-task solve needs pipeline=True (see "
                "repro_torch.dist.mesh.task_axis_policy)")
    else:
        X_host = _validate_solver_inputs(X_host, y, loss)
    setup = prepare_solver(
        X_host, loss, mesh=mesh, mesh_axes=mesh_axes,
        y=y if multitask else None, block_size=block_size,
        delay_rounds=delay_rounds, pod_delay_rounds=pod_delay_rounds,
        seed=seed, record=record, use_kernel=use_kernel,
        gap_every=gap_every, pipeline=pipeline, overlap=overlap,
        shrink_every=shrink_every, shrink_tol=shrink_tol, repack=repack,
        repack_threshold=repack_threshold, adaptive=adaptive,
        adaptive_ratio=adaptive_ratio, device=dev)
    draw = _block_schedule(setup, blocks, epochs)
    alpha, w = _init_alpha_w(setup, alpha0, w0)
    overlap_fns = workspaces = None
    if setup.two_d:
        cols, vals = setup.X
        workspaces = _workspaces(setup)
        engine = functools.partial(
            _block_update_2d(setup.loss, setup.fused, workspaces[0],
                             setup.n_loc, setup.Y), cols, vals,
            setup.sq_norms)
        if setup.overlap:
            overlap_fns = _overlap_round_fns(cols, vals, setup.sq_norms,
                                             setup.loss, setup.n_loc,
                                             setup.Y)
        gap = _make_gap_2d(setup.loss, cols, vals, segments=setup.segs)
    else:
        engine = functools.partial(
            _block_update_1d(setup.loss, setup.ell, setup.n_loc, setup.Y),
            setup.X, setup.sq_norms)
        gap = _make_gap_1d(setup.loss, setup.X, setup.ell, setup.w_shape[0],
                           segments=setup.segs)
    alpha, w, dw, gaps, eps, active, delay = _epoch_scan(
        setup, engine, gap, draw, alpha, w, epochs=epochs,
        overlap_fns=overlap_fns, workspaces=workspaces)
    st = setup.tuning
    if (setup.delay_rounds > 0 or st.shrink_every or st.adaptive
            or setup.pod_delay_rounds > 0):
        w = w + dw  # flush the in-flight aggregate (0 when synchronous)
    return _finalize(setup, alpha, w, gaps, epochs, eps, active, delay)


sharded_passcode_solve.host_reads = 0
sharded_passcode_solve.epoch_rounds = []
sharded_passcode_solve.task_rounds = []


def sharded_passcode_feature(X_host, loss, *, mesh=None, epochs: int = 10,
                             seed: int = 0):
    """The reference's back-compat shim (one n-row block per epoch on the
    2-D mesh).  Not ported: its B = n would need an n × n Gram."""
    raise NotImplementedError(
        "sharded_passcode_feature (one block of B = n rows, an n × n Gram) "
        "is ROADMAP A′.12, not yet ported; call sharded_passcode_solve "
        "with mesh=solver_mesh_2d(model=m)")
