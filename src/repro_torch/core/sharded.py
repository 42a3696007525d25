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

**The carried state** (the reference's ``SolverState``).  A solve is a
flat dict of tensors with the reference's key names
(``pipeline_state_keys``, the checkpoint schema): α, w, the Δw in
flight, the key chain, the record buffers and the self-tuning, pod FIFO
and watchdog latches, each with the leading K (the epoch and the record
slot, which the host's loop drives, live on the host).
``init_pipeline_state`` makes the epoch-0 state, ``build_pipeline`` a
segment runner that advances it by some epochs of a ``total_epochs``
schedule, every decision keyed on the global epoch, and
``finalize_state`` the result: ``sharded_passcode_solve`` is one such
segment, and ``repro_torch.resilience.solve_segmented`` chains several
(bit for bit the whole solve) with the watchdog's health code, the fault
triple and the degraded knobs of a retry.

**The per-epoch host driver** (``pipeline=False``, the reference's
legacy path).  ``make_sharded_epoch`` and ``make_sharded_epoch_2d`` build
one epoch over an explicit block schedule ((p·n_blocks, B) shard-local
ids, shard i owning rows [i·n_blocks, (i+1)·n_blocks)) on the same round
engines the pipelined solve runs (``_scan_rounds``, and on the 2-D mesh
with ``overlap`` the overlapped round with its prologue (base, Gram)
rebuilt each dispatch and its last round wrapping to the epoch's own
first block); ``_drive_epochs`` draws each epoch's blocks from the one
key chain the pipelined solve consumes, dispatches the epoch, keeps the
gap on the device and flushes the delayed Δw at the end.
``sharded_passcode_feature`` is the reference's back-compat shim: one
block of B = n rows an epoch on a (data = 1, model = m) mesh, whose
n × n Gram takes B4 and B5 past 1,024 ids (their device-memory layout,
``gram_plan``/``feature_update_plan``).

**Across processes** (a mesh spread over the ranks of a process group,
``repro_torch.dist.mesh.with_ranks``; the reference's mesh over real
devices).  The mesh's sizes stay the global (P, p, m); each axis's
shards split contiguously over its ranks.  X stays where the caller
has it, and a rank copies only its part to the device
(``prepare_solver``): the rows, labels and α of its data shards, and on
the 2-D mesh its feature shards' slices of X and w.  It draws
its own shards' blocks from the one key chain, and launches its kernels
over its own shards (B4 and B5 laid out for the mesh's m).  Every psum
site gathers the partials into the one-process layout and reduces it
with the same torch op (``repro_torch.dist.collectives``): the rounds'
Δw over ``data`` (``_shard_sum``), B4's partials, the base correction
and the unfused dot over ``model`` (``_ModelPsum``), the pods' Δw_pod
over ``pod``; the records' per-row terms and the m slices of w(α) the
same way, an ELL or 2-D w(α) itself as exact int64 SUMs on the card,
the fixed-point scale from the global bound (one gap closure,
``_gap_closure``, whose collectives are the identity on one process);
the active count and the census as int64 SUMs, the repacked round count
as a MAX.  So a W-rank solve is the one-process solve's α and ŵ bit for
bit at the same mesh and seed, and on the card its ELL and 2-D records
too (a dense w(α) adds float partials in rank order); every rank
returns the whole result
(``_finalize`` gathers).  With no process group, or a one-rank mesh, no
line of this runs.
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
    ell_split_width,
    flat_shard_ids,
)
from repro_torch.dist.collectives import gather_axis, max_all, sum_int
from repro_torch.dist.mesh import (
    SelfTuning,
    SolverMesh,
    adaptive_delay_policy,
    dp_size,
    pipeline_overlap,
    pod_merge_policy,
    rank_layout,
    resolve_device,
    resolve_self_tuning,
    solver_mesh_2d,
    task_axis_policy,
    watchdog_trip,
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


def _shard_sum(dw, pods: int = 1, lay=None):
    """The psum over ``data``: each task's p shards' Δw (K, p, *w)
    summed in shard order, (K, *w); with ``pods`` P > 1 the P·p shards
    are P pods' and each pod's p shards sum apart, (K, P, *w) — the
    reference's pod-local round psum.  Across ranks (``lay``, a
    ``RankLayout``) ``dw`` holds this rank's shards, (K, P_loc·p_loc,
    *w): each of its pods' shards are gathered over ``data`` into the
    pod's p, then summed as on one process; the result keeps the pod
    dimension (K, P_loc, *w) whenever P > 1."""
    if lay is not None:
        P, K, rest = pods // lay.count("pod"), dw.shape[0], dw.shape[2:]
        dw = gather_axis(dw.reshape(K, P, -1, *rest), lay, "data", 2)
        if pods > 1:
            return _shard_sum(dw.reshape(K * P, -1, *rest)).view(K, P, *rest)
        return _shard_sum(dw.reshape(K, -1, *rest))
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


class _ModelPsum:
    """The psum over ``model`` of a rank's feature shards, by the design
    rule of ``repro_torch.dist.collectives``: ``psum(t, dim)`` gathers a
    partial already reduced (the shards on ``dim``) into the one-process
    layout of the m shards, for the caller's own sum; ``psum.dots(prod)``
    is the shards' Σ_k of a (…, m_loc, k) product, gathered to (…, m).
    On the card each shard's run is summed where it sits in the
    one-process (…, m, k) product — the rank's runs placed in zeros —
    because torch's reduction over k reads a run from its alignment."""

    def __init__(self, lay, m: int):
        self.lay, self.m = lay, m
        self.m0, self.m_loc = lay.span("model", m)

    def __call__(self, t, dim):
        return gather_axis(t, self.lay, "model", dim)

    def dots(self, prod):
        if prod.is_cuda:
            full = prod.new_zeros((*prod.shape[:-2], self.m, prod.shape[-1]))
            full[..., self.m0:self.m0 + self.m_loc, :] = prod
            part = torch.sum(full, dim=-1)[..., self.m0:self.m0 + self.m_loc]
        else:
            part = torch.sum(prod, dim=-1)
        return self(part, part.dim() - 1)


def _model_gather(lay, m: int):
    """The psum over ``model`` (``_ModelPsum``) of a rank holding some
    of the ``m`` feature shards, or None where every one is here."""
    if lay is None or lay.count("model") == 1:
        return None
    return _ModelPsum(lay, m)


def _local_block_update_feature(cols, vals, sq_norms, alpha, w, idx_block,
                                loss, act=None, y=None, gather=None):
    """The unfused 2-D engine (the reference's
    ``_local_block_update_feature``) for one data shard of one task: B
    sequential updates of the row ids ``idx_block``, each summing the m
    shards' O(k_loc) partial dots — the reference's per-update psum over
    ``model`` — and scattering into every shard's own slice.
    ``sq_norms`` are the full row norms, so δ is one value for all
    shards; ``act`` (0/1) freezes shrunk rows; ``y`` folds the task's
    labels on read.  Returns (updated α, Δw over the (m, d_loc + 1)
    slices).  ``gather`` (``_model_gather``) takes this rank's shards'
    partial dots to all m before their sum, every update."""
    alpha, w_cur = alpha.clone(), w.clone()
    d1 = w.shape[1]
    w_flat = w_cur.view(-1)
    for i in idx_block.tolist():
        ids = flat_shard_ids(cols[i], d1)  # (m, k)
        v = vals[i]
        prod = w_flat[ids] * v
        wx = torch.sum(torch.sum(prod, dim=1) if gather is None
                       else gather.dots(prod))
        if y is not None:
            wx = y[i] * wx
        delta = loss.delta(alpha[i], wx, sq_norms[i])
        if act is not None:
            delta = torch.where(act[i] > 0.0, delta, 0.0)
        alpha[i] = alpha[i] + delta
        dscale = delta if y is None else delta * y[i]
        w_flat.index_add_(0, ids.reshape(-1), (dscale * v).reshape(-1))
    return alpha, w_cur - w


def _block_update_2d(loss, fused: bool, workspace, n_loc: int = 0, Y=None,
                     gather=None):
    """The 2-D block engine over K tasks of p data shards (eager
    composition; the overlapped round drives the split phases directly):
    α (K, n_pad), w_eff (K, m, d_loc + 1) or (K, p, m, d_loc + 1), ids
    (p, B) or (K, p, B); a w_eff (K, P, m, d_loc + 1) for 1 < P < p is
    a view a pod.  Returns (updated α, the pairs' Δw (K, p, m,
    d_loc + 1)).  The unfused engine runs the tasks, then the shards, in
    order.  Where m is this rank's feature shards, ``gather``
    (``_model_gather``) takes the partials to all m before each psum
    over ``model``, and the workspace's ``m_all`` lays out B4 and B5 for
    the mesh's m."""

    def block_update(cols, vals, sq_norms, alpha, w_eff, idx_block,
                     act=None):
        if fused:
            return dcd_feature_block_update(cols, vals, sq_norms, alpha,
                                            w_eff, idx_block, loss=loss,
                                            active=act, y=Y,
                                            workspace=workspace,
                                            n_loc=n_loc, gather=gather)
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
                    _task_rows(Y, k), gather)
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


def _masked_block_perms(key, p: int, n_loc: int, n_rows: int,
                        n_blocks: int, block_size: int):
    """All shards' masked block permutations for one epoch, drawn on the
    host (the ``pipeline=False`` driver): row ``my`` is
    ``_device_block_perm(key, my, …)`` flattened.  Returns (p,
    n_blocks·B) int32."""
    return torch.stack([
        _device_block_perm(key, my, p, n_loc, n_rows, n_blocks,
                           block_size).reshape(-1) for my in range(p)])


def _scan_rounds(block_update, alpha_loc, w_loc, dw_prev, blocks_loc,
                 delay_rounds: int, pods: int = 1, lay=None):
    """The round structure: per round the block engine runs against the
    (possibly stale) effective w, and its Δw — each task's summed over
    the ``data`` shards — is applied now (atomic) or one round late
    (``delay_rounds``), the reference's exact bookkeeping.
    ``block_update(alpha, w_eff, idx_block)`` closes over the shards;
    α, w and Δw carry the leading task dimension K, and with ``pods``
    P > 1 a pod dimension after it (w and Δw (K, P, *w): each pod's
    rounds read and update its own w, the psum pod-local).  Across ranks
    (``lay``) the shards are this rank's and ``_shard_sum`` gathers."""
    for idx_block in blocks_loc:
        w_eff = w_loc + dw_prev if delay_rounds > 0 else w_loc
        alpha_loc, dw_loc = block_update(alpha_loc, w_eff, idx_block)
        dw_all = _shard_sum(dw_loc, pods, lay)
        if delay_rounds > 0:
            w_loc, dw_prev = w_loc + dw_prev, dw_all
        else:
            w_loc = w_loc + dw_all
    return alpha_loc, w_loc, dw_prev


def _scan_rounds_dyn(block_update, alpha, w, dw_prev, dw_own, blocks, act,
                     n_run: int, delay_flag, runs=None, n_all: int = 0,
                     lay=None):
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
        dw_all = _shard_sum(dw_loc, 1, lay)
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


def _overlap_round_fns(cols, vals, sq_norms, loss, n_loc: int = 0, Y=None,
                       gather=None):
    """The three split phases of the fused 2-D block round, bound to the
    resident slices (``repro_torch.kernels.ops`` entry points), over K
    tasks of the (p, B) shard-local ids.  B4 (``gram_fn``) fills the
    workspace it is given with the block's buckets, which B5
    (``update_fn``) of the same block reads.  ``gather``: as for
    ``_block_update_2d``."""

    def gram_fn(w_ref, idx, workspace):
        return dcd_feature_gram(cols, vals, w_ref, idx, workspace=workspace,
                                n_loc=n_loc, tasks=True, gather=gather)

    def corr_fn(dvec, idx):
        return dcd_feature_base_correction(cols, vals, dvec, idx,
                                           n_loc=n_loc, tasks=True,
                                           gather=gather)

    def update_fn(alpha, w_ref, idx, base, gram, workspace, act=None):
        return dcd_feature_update(cols, vals, sq_norms, alpha, w_ref, idx,
                                  base, gram, loss=loss, active=act, y=Y,
                                  workspace=workspace, n_loc=n_loc)

    return gram_fn, corr_fn, update_fn


def _scan_rounds_overlap(gram_fn, corr_fn, update_fn, alpha, w, dw_prev,
                         blocks, inflight, next0, workspaces, act=None,
                         lay=None):
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
                                _shard_sum(w_upd - _per_shard(w_next), 1,
                                           lay),
                                inflight_next)
    return alpha, w, dw_prev, inflight


def _check_interpret(interpret):
    """``interpret`` picks the Pallas kernels' interpreter in the
    reference; the port has none, so only its default (None) is taken."""
    if interpret is not None:
        raise ValueError(
            f"interpret={interpret!r}: the port has no kernel interpreter "
            "(a CPU tensor runs the kernels' plain versions)")


def _round_major(blocks_idx, p: int, device):
    """(p·n_blocks, B) shard-local ids, shard i owning rows
    [i·n_blocks, (i+1)·n_blocks), as the round scan's (n_blocks, p, B)."""
    b = torch.as_tensor(blocks_idx, dtype=torch.int32, device=device)
    if b.dim() != 2 or b.shape[0] % p:
        raise ValueError(f"blocks_idx must be (p·n_blocks, B) for p = {p}, "
                         f"got {tuple(b.shape)}")
    return b.view(p, -1, b.shape[1]).transpose(0, 1).contiguous()


def _own_blocks(blocks, lay):
    """A round-major (n_blocks, p, B) schedule's columns of this rank's
    ``data`` shards (all of them on one process)."""
    if lay is None:
        return blocks
    d0, dn = lay.span("data", blocks.shape[1])
    return blocks[:, d0:d0 + dn]


def make_sharded_epoch(mesh, loss, *, delay_rounds: int = 0,
                       use_kernel="auto", interpret=None, ell: bool = False,
                       device=None):
    """One epoch of the 1-D solver over an explicit block schedule — the
    reference's ``make_sharded_epoch`` (the ``pipeline=False`` path):
    ``epoch(X, sq_norms, alpha, w, blocks_idx, carry_dw) → (alpha, w,
    carry_dw)`` runs ``_scan_rounds`` over the B1 (``ell``: X a (cols,
    vals) pair, w the (d + 1,) primal with the dummy slot at d) or B2
    (dense X, w (d,)) shard grid.  α is the (p·n_loc,) row-padded dual
    of the solver's layout (``prepare_solver``), ``blocks_idx`` the
    (p·n_blocks, B) shard-local ids, ``carry_dw`` the Δw in flight
    (``delay_rounds``).  The engine follows the tensors' device (the
    kernels for CUDA tensors); ``device`` is where the epoch may run,
    the card unless the caller asks for the CPU.  On a mesh spread over
    ranks X and α are this rank's shards', ``blocks_idx`` stays every
    shard's schedule (each rank runs its own shards' ids) and the psum
    gathers (``_shard_sum``)."""
    _check_interpret(interpret)
    dev = resolve_device(device)
    _check_use_kernel(use_kernel, dev)
    if tuple(mesh.axis_names) != ("data",):
        raise ValueError(f"make_sharded_epoch needs a ('data',) mesh, got "
                         f"{tuple(mesh.axis_names)}")
    p, delay, lay = dp_size(mesh), int(delay_rounds), rank_layout(mesh)

    def epoch(X, sq_norms, alpha, w, blocks_idx, carry_dw):
        blocks = _own_blocks(_round_major(blocks_idx, p, alpha.device), lay)
        n_loc = alpha.shape[-1] // blocks.shape[1]
        engine = functools.partial(_block_update_1d(loss, ell, n_loc), X,
                                   sq_norms)
        a, w_new, dw = _scan_rounds(engine, alpha[None], w[None],
                                    carry_dw[None], blocks, delay, lay=lay)
        return a[0], w_new[0], dw[0]

    return epoch


def make_sharded_epoch_2d(mesh, loss, *, delay_rounds: int = 0,
                          use_kernel="auto", interpret=None, overlap=False,
                          device=None):
    """One epoch of the 2-D feature-sharded solver over an explicit block
    schedule — the reference's ``make_sharded_epoch_2d``: X the (cols,
    vals) pair of (p·n_loc, m, k_loc) slices, w the (m, d_loc + 1)
    slices, α and ``blocks_idx`` as for ``make_sharded_epoch``.  The
    engine is the fused B4 → B5 round for ``use_kernel`` True (and
    "auto" on the card), else the unfused one; ``overlap`` (validated by
    ``pipeline_overlap``) runs the overlapped round with the per-dispatch
    prologue: the (base, Gram) of the epoch's first block is formed
    against the entering w each dispatch, and the last round's peek
    wraps to that same first block (the pipelined solve instead carries
    the aggregate across epochs).  B4's workspaces are allocated at the
    first call and kept while the shapes stay.  On a mesh spread over
    ranks the operands are this rank's shards', as for
    ``make_sharded_epoch``, and the psums over ``model`` gather too."""
    _check_interpret(interpret)
    dev = resolve_device(device)
    _check_use_kernel(use_kernel, dev)
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError(f"make_sharded_epoch_2d needs a ('data', 'model') "
                         f"mesh, got {tuple(mesh.axis_names)}")
    fused = _fused_2d(use_kernel, dev)
    delay = int(delay_rounds)
    overlap = pipeline_overlap(overlap, two_d=True, fused=fused,
                               delay_rounds=delay)
    p, m, lay = dp_size(mesh), mesh.shape["model"], rank_layout(mesh)
    gather = _model_gather(lay, m)
    kept = {}

    def epoch(X, sq_norms, alpha, w, blocks_idx, carry_dw):
        cols, vals = X
        blocks = _own_blocks(_round_major(blocks_idx, p, alpha.device), lay)
        p_loc = blocks.shape[1]
        n_loc = alpha.shape[-1] // p_loc
        shape = (tuple(cols.shape), blocks.shape[-1], w.shape[-1])
        if fused and kept.get("shape") != shape:
            kept.update(shape=shape, ws=_gram_workspaces(
                cols, blocks.shape[-1], w.shape[-1], p_loc, 1, overlap, m))
        ws = kept["ws"] if fused else (None, None)
        a, w_new, dw = alpha[None], w[None], carry_dw[None]
        if overlap:
            gram_fn, corr_fn, update_fn = _overlap_round_fns(
                cols, vals, sq_norms, loss, n_loc, gather=gather)
            inflight = (*gram_fn(w_new, blocks[0], ws[0]), ws[0])
            a, w_new, dw, _ = _scan_rounds_overlap(
                gram_fn, corr_fn, update_fn, a, w_new, dw, blocks, inflight,
                blocks[0], ws, lay=lay)
        else:
            engine = functools.partial(
                _block_update_2d(loss, fused, ws[0], n_loc, gather=gather),
                cols, vals, sq_norms)
            a, w_new, dw = _scan_rounds(engine, a, w_new, dw, blocks, delay,
                                        lay=lay)
        return a[0], w_new[0], dw[0]

    return epoch


def _drive_epochs(epoch_fn, X, sq_norms, alpha, w, carry_dw, *, p, n_loc,
                  n, n_blocks, block_size, epochs, key, record, gap_every,
                  delay_rounds, gap_fn, draw=None):
    """The host-side per-epoch driver (the reference's ``pipeline=False``
    path): each epoch splits the one key chain the pipelined solve
    consumes (``key, sub = split(key)``), draws every shard's masked
    block permutation (``_masked_block_perms``; ``draw(e, sub)`` —
    ``_block_draw``'s, for an explicit schedule — in its place when
    given), dispatches the epoch and, every ``gap_every`` epochs and at
    the last, keeps ``gap_fn(alpha, w)`` on the device; one host read
    after the solve.  The delayed Δw in flight is flushed at the end.
    Returns (alpha, w, gaps)."""
    gap_every = max(int(gap_every), 1)
    solve = sharded_passcode_solve
    gaps = []
    for e in range(epochs):
        key, sub = prng.split(key)
        if draw is None:
            blocks = _masked_block_perms(sub, p, n_loc, n, n_blocks,
                                         block_size)
        else:
            blocks = draw(e, sub).transpose(0, 1)
        solve.epoch_rounds.append(n_blocks)
        solve.task_rounds.append([n_blocks])
        alpha, w, carry_dw = epoch_fn(
            X, sq_norms, alpha, w, blocks.reshape(p * n_blocks, block_size),
            carry_dw)
        if record and ((e + 1) % gap_every == 0 or e == epochs - 1):
            gaps.append(gap_fn(alpha, w + carry_dw))
    if delay_rounds > 0:
        w = w + carry_dw  # flush the in-flight aggregate
    gaps = (torch.stack(gaps) if gaps
            else torch.zeros((0,), dtype=torch.float32, device=alpha.device))
    return alpha, w, gaps


def _gap_slots(epochs: int, gap_every: int) -> int:
    """How many duality gaps the solve records — every ``gap_every``-th
    epoch plus the final one."""
    gap_every = max(int(gap_every), 1)
    return sum(1 for e in range(epochs)
               if (e + 1) % gap_every == 0 or e == epochs - 1)


def _abs_max(t):
    """max |t| as a device scalar, with no |t| temporary (webspam's
    values are 14 GB)."""
    return torch.maximum(t.amax(), t.amin().neg())


def _fixed_point_scale(bound):
    """The scale 2^⌊62 − log₂ bound⌋ of ``_scatter_fixed``: a sum of
    terms whose magnitudes add to at most ``bound`` stays inside int64
    (a device scalar, float64; no host read)."""
    return torch.exp2(torch.floor(
        62.0 - torch.log2(bound.double().clamp(min=1e-30))))


def _scatter_fixed(acc, idx, terms, scale):
    """``acc.index_add_(0, idx, terms)`` into an int64 accumulator of
    fixed-point words (``terms`` × ``scale``, rounded): integer adds
    commute, so the sum is the same bits whichever order the card's
    atomics land in, where float atomics' are not."""
    acc.index_add_(0, idx, torch.round(terms.double() * scale).long())


def _from_fixed(acc, scale, bound):
    """The float32 sum out of ``_scatter_fixed``'s accumulator; NaN
    where ``bound`` is not finite (a NaN α or value poisons the sum, as
    it does a float one)."""
    out = (acc.double() / scale).float()
    return torch.where(torch.isfinite(bound), out, float("nan"))


def _cat_rows(parts, like):
    """The parts concatenated on their first dimension (the one part
    itself; an empty tensor like ``like`` for none)."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts) if parts else like[:0]


def _row_dots(cols, vals, w_view, rows: int, psum=None):
    """wᵀx_i of every row of the feature shards, each the sum of the
    shards' partial dots, in row chunks of ``rows`` rows (no (n, m,
    k_loc) temporary at webspam's size).  Where ``cols``/``vals``/
    ``w_view`` hold a rank's feature shards, ``psum``
    (``_ModelPsum.dots``) gathers the m partial dots before their sum."""
    d1, flat = w_view.shape[1], w_view.reshape(-1)
    return torch.cat([
        torch.sum(torch.sum(prod, dim=2) if psum is None else psum.dots(prod),
                  dim=1)
        for prod in (flat[flat_shard_ids(c, d1)] * v
                     for c, v in zip(cols.split(rows), vals.split(rows)))])


def _gap_closure(loss, X, *, ell: bool, two_d: bool = False, runs=None,
                 lay=None, spread=None, chunk_elems: int = 1 << 26):
    """The duality gap and the backward-error metric: gap(α) = ‖w(α)‖²
    + Σ_i [ℓ(w(α)ᵀx_i) + ℓ*(−α_i)] over the real rows, and ‖w(α) − ŵ‖
    against the maintained primal view ``w_view`` (ε = w̄ − ŵ of
    ``core/backward_error.py``).  ``X`` is an ELL (cols, vals) pair of
    (rows, k) (``ell``), a dense (rows, d) matrix, or with ``two_d`` the (cols,
    vals) of (rows, m, k_loc) feature slices; its real rows are the runs
    ``runs`` ((start, _, count) each; all of them for None).
    ``gap(α, w_view, y)`` takes α (and ``y``, one task's labels folded
    on read: w(α) = Σ α_i·y_i·x_i, the margin y_i·w(α)ᵀx_i, ℓ*(−α) of
    α) over X's rows and returns device scalars, no host sync.  The 2-D
    w(α) stays one slice per shard, each row's dot and ‖w(α)‖² are sums
    of the shards' partials (the reference's psums over ``model``), in
    row chunks of about ``chunk_elems`` entries, scattering only real
    entries.  On the card an ELL w(α) is summed in fixed point
    (``_scatter_fixed``), so a record is the same bits run to run; on
    the CPU the float scatter is already in a fixed order.

    Across ranks (``lay``) X holds this rank's rows and feature shards,
    and each psum gathers into the one-process layout and reduces as
    there (every collective is the identity on one process): the real
    rows' terms are taken by ``spread`` to the whole solve's real rows
    in the user's order and summed there; ‖w(α)‖² and ε over the m
    gathered slices; each row's dot over the m gathered partial dots
    (``_ModelPsum``).  An ELL w(α) on the card is summed at the scale of
    the whole solve's bound (Σ|α_i| over all real rows times the MAX of
    the ranks' largest |value|), the ranks' int64 words added exactly,
    so the records are the one-process solve's bits; a dense w(α), and
    any w(α) on the CPU, adds the ranks' float partials in rank order:
    within float rounding of the one-process records, not their bits."""
    ell = ell or two_d
    rows_all = X[0] if ell else X
    runs = ((0, 0, rows_all.shape[0]),) if runs is None else runs
    spread = spread or (lambda t: t)
    dp = ("pod", "data")

    def cut(t):
        return _cat_rows([t[a:a + c] for a, _, c in runs], t)

    if ell:
        cols, vals = X
        parts = [(cols[a:a + c], vals[a:a + c]) for a, _, c in runs]
    else:
        parts = [X[a:a + c] for a, _, c in runs]
    fixed = ell and vals.is_cuda and vals.numel() > 0
    if fixed:
        vmax = max_all(torch.stack([_abs_max(v) for _, v in parts]
                                   or [vals.new_zeros(())]).amax(), lay)
    psum, rows = None, 0
    if two_d:
        m_all = cols.shape[1] * (lay.count("model") if lay else 1)
        psum = _model_gather(lay, m_all)
        rows = max(1, chunk_elems // (m_all * cols.shape[2]))

    def entries(ay, d1):
        """w(α)'s (ids, terms) part by part: the 2-D slices' real
        entries a row chunk at a time, or the ELL rows'."""
        for (cp, vp), ap in zip(parts, (ay[a:a + c] for a, _, c in runs)):
            if not two_d:
                yield cp.reshape(-1).long(), (ap[:, None] * vp).reshape(-1)
                continue
            for c, v, a in zip(cp.split(rows), vp.split(rows),
                               ap.split(rows)):
                real = c < d1 - 1  # padding lanes would add 0 at dummies
                yield flat_shard_ids(c, d1)[real], (a[:, None, None]
                                                    * v)[real]

    def rmv(ay, w_view):
        if not ell:
            wa = torch.zeros_like(w_view) if not parts else None
            for X_p, (a, _, c) in zip(parts, runs):
                t = X_p.T @ ay[a:a + c]
                wa = t if wa is None else wa + t
            return _gather_shard_sum(wa, lay)
        acc = torch.zeros((w_view.numel(),),
                          dtype=torch.int64 if fixed else torch.float32,
                          device=ay.device)
        if fixed:
            bound = spread(cut(ay)).abs().sum() * vmax
            scale = _fixed_point_scale(bound)
        for ids, terms in entries(ay, w_view.shape[-1]):
            if fixed:
                _scatter_fixed(acc, ids, terms, scale)
            else:
                acc.index_add_(0, ids, terms)
        if fixed:
            return _from_fixed(sum_int(acc, lay, dp), scale, bound)
        return _gather_shard_sum(acc, lay)

    def mv(wa):
        if two_d:
            z = [_row_dots(cp, vp, wa, rows, psum) for cp, vp in parts]
        elif ell:
            z = [torch.sum(wa[c.long()] * v, dim=1) for c, v in parts]
        else:
            z = [X_p @ wa for X_p in parts]
        return _cat_rows(z, wa.reshape(-1))

    def gap(alpha, w_view, y=None):
        ay = alpha if y is None else alpha * y
        wa = rmv(ay, w_view).view(w_view.shape)
        z = mv(wa)
        if y is not None:
            z = cut(y) * z
        s = torch.sum(spread(loss.primal_loss(z) + loss.conj(cut(alpha))))
        if two_d:
            e = gather_axis(wa - w_view, lay, "model", 0)
            wa = gather_axis(wa, lay, "model", 0)
            return (torch.sum(torch.sum(wa * wa, dim=1)) + s,
                    torch.sqrt(torch.sum(torch.sum(e * e, dim=1))))
        e = wa - w_view  # the dummy slot is 0 in both
        return torch.dot(wa, wa) + s, torch.sqrt(torch.dot(e, e))

    return gap


def _gather_shard_sum(t, lay):
    """The ranks' float partials of one sum over ``data`` and ``pod``,
    added in rank order (the same order on every rank); ``t`` itself on
    one process."""
    if lay is None:
        return t
    for axis in ("data", "pod"):
        t = gather_axis(t[None], lay, axis, 0).sum(0)
    return t


def _task_gaps(gap, alpha, w_view, Y):
    """Each task's (gap, ‖w(α) − ŵ‖), task by task with its labels
    folded on read: two (K,) device tensors."""
    out = [gap(alpha[k], w_view[k], None if Y is None else Y[k])
           for k in range(alpha.shape[0])]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


def _make_shrink(setup, X=None, chunk_elems: int = 1 << 26):
    """The active-mask recompute (the reference's ``_make_shrink_1d`` /
    ``_2d``), task by task: fresh projected gradients from (α, w_view) —
    wᵀx_i by the layout's own matvec (on the 2-D mesh the sum of the
    shards' partial dots, in row chunks), y_i·wᵀx_i with the task's
    labels — through ``active_mask_from_w``, ANDed with row validity so
    padding rows never count as active.  Returns a (K, n_pad) bool
    mask, a row a task, and the (n_pad,) validity.  ``X`` is the dataset
    the segment runs on (``setup.X`` by default).  Across ranks the rows
    are this rank's, each 2-D dot the sum of the m gathered partial
    dots."""
    X = setup.X if X is None else X
    valid = _local_valid(setup)
    if setup.two_d:
        cols, vals = X
        psum = _model_gather(setup.lay, setup.m)
        rows = max(1, chunk_elems // (setup.m * cols.shape[2]))

        def mv(wv):
            return _row_dots(cols, vals, wv, rows, psum)
    elif setup.ell:
        cols, vals = X

        def mv(wv):
            return torch.sum(wv[cols.long()] * vals, dim=1)
    else:
        def mv(wv):
            return X @ wv

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
    # across ranks (``repro_torch.dist.mesh.rank_layout``): the layout,
    # the global ids of the data shards held here and their real rows'
    # runs in this rank's layout, and the feature shards held here
    # (p, m, n_pad and segs stay the whole mesh's; X, sq_norms, Y and
    # w_shape are this rank's)
    lay: object = None
    local: tuple = ()
    segs_loc: tuple = ()
    m_here: int = 0

    @property
    def n_pad(self) -> int:
        return self.p * self.n_loc

    @property
    def p_loc(self) -> int:
        """The data shards held here (all p on one process)."""
        return len(self.local) if self.local else self.p

    @property
    def n_pad_loc(self) -> int:
        return self.p_loc * self.n_loc

    @property
    def pods_loc(self) -> int:
        return self.pods // (self.lay.count("pod") if self.lay else 1)

    @property
    def m_loc(self) -> int:
        return self.m_here or self.m

    @property
    def m0(self) -> int:
        """The first feature shard held here."""
        return self.lay.span("model", self.m)[0] if self.lay else 0

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
        mesh = solver_mesh_2d(data=1, model=mesh.shape["model"])._replace(
            device_mesh=getattr(mesh, "device_mesh", None))
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


def _local_shards(lay, p: int, pods: int) -> tuple:
    """The global ids of a rank's data shards, in its layout's order:
    its pods' (``pod`` span) shards of its ``data`` span each, shard
    k·p_pod + my of pod k."""
    p_pod = p // pods
    k0, kn = lay.span("pod", pods)
    d0, dn = lay.span("data", p_pod)
    return tuple(k * p_pod + my for k in range(k0, k0 + kn)
                 for my in range(d0, d0 + dn))


def _local_runs(segs, local, n_loc: int) -> tuple:
    """The runs (start, user row, count) of the real rows in a rank's
    layout: its j-th shard s holds the global slots [s·n_loc,
    (s+1)·n_loc) of the layout whose real rows are ``segs``, at
    [j·n_loc, (j+1)·n_loc).  Adjacent runs merge."""
    runs = []
    for j, s in enumerate(local):
        g0, g1 = s * n_loc, (s + 1) * n_loc
        for start, src, c in segs:
            a, b = max(start, g0), min(start + c, g1)
            if a >= b:
                continue
            run = (j * n_loc + a - g0, src + a - start, b - a)
            if runs and (runs[-1][0] + runs[-1][2], runs[-1][1]
                         + runs[-1][2]) == run[:2]:
                runs[-1] = (*runs[-1][:2], runs[-1][2] + run[2])
            else:
                runs.append(run)
    return tuple(runs)


def _place_local(t, rows: int, runs, fill, device, dtype=None):
    """A rank's ``rows`` slots, a new tensor on ``device``: its real rows
    the runs ``runs`` (``_local_runs``) of ``t``'s rows, copied from
    wherever ``t`` lies, every other slot ``fill`` — only this rank's
    rows reach ``device``, and nothing keeps ``t`` alive."""
    out = torch.full((rows, *t.shape[1:]), fill, dtype=dtype or t.dtype,
                     device=device)
    for start, src, c in runs:
        out[start:start + c].copy_(t[src:src + c])
    return out


def _split_local(mat: EllMatrix, m: int, span: tuple, runs, rows: int,
                 dev, chunk_elems: int = 1 << 26):
    """A rank's feature shards ``span`` (first, count) of its rows (the
    runs ``runs`` of its ``rows`` slots) on ``dev``, split from ``mat``
    (on the host or the card) a row chunk at a time on ``dev`` — never
    the whole split, nor the whole of ``mat`` on ``dev``: the (rows,
    m_loc, k_loc) slices at the whole split's k_loc (the widest chunk's
    ``ell_split_width``) and every row's ‖x_i‖² over all m shards,
    summed over the same chunks of the whole split as
    ``FeatureShardedEll.row_sq_norms`` sums them, so the bits are the
    one-process layout's.  Returns ((cols, vals), sq_norms, d_loc)."""
    j0, mj = span
    d, n = mat.n_features, mat.n_rows
    step = max(1, chunk_elems // mat.indices.shape[1])

    def chunk(r0, r1):
        return EllMatrix(mat.indices[r0:r1].to(dev),
                         mat.values[r0:r1].to(dev), d)

    k_loc = max(ell_split_width(chunk(r0, r0 + step), m,
                                chunk_elems=chunk_elems)
                for r0 in range(0, n, step))
    d_loc = -(-d // m)
    cols = torch.full((rows, mj, k_loc), d_loc, dtype=torch.int32,
                      device=dev)
    vals = torch.zeros((rows, mj, k_loc), dtype=torch.float32, device=dev)
    sq = torch.ones((rows,), dtype=torch.float32, device=dev)
    step = max(1, chunk_elems // (m * k_loc))  # row_sq_norms' row chunks
    for r0 in range(0, n, step):
        r1 = min(r0 + step, n)
        hits = [run for run in runs if run[1] < r1 and run[1] + run[2] > r0]
        if not hits:
            continue
        ch = ell_column_split(chunk(r0, r1), m, k_loc,
                              chunk_elems=chunk_elems)
        q = torch.sum(ch.values * ch.values, dim=(1, 2))
        for start, src, c in hits:
            lo, hi = max(src, r0), min(src + c, r1)
            dst = slice(start + lo - src, start + hi - src)
            cols[dst] = ch.indices[lo - r0:hi - r0, j0:j0 + mj]
            vals[dst] = ch.values[lo - r0:hi - r0, j0:j0 + mj]
            sq[dst] = q[lo - r0:hi - r0]
    return (cols, vals), sq, d_loc


def _gather_shards(setup: SolverSetup, t, dim: int):
    """A tensor whose dimension ``dim`` holds this rank's data shards
    (P_loc·p_loc of them, its pods' in order) gathered over ``data`` and
    ``pod`` into all P·p in the one-process order; the identity on one
    process."""
    if setup.lay is None:
        return t
    v = t.unflatten(dim, (setup.pods_loc, -1))
    v = gather_axis(v, setup.lay, "data", dim + 1)
    return gather_axis(v, setup.lay, "pod", dim).flatten(dim, dim + 1)


def _gather_rows(setup: SolverSetup, t):
    """A per-row (…, n_pad_loc) tensor of this rank's shards gathered
    over ``data`` and ``pod`` into the whole layout's (…, n_pad); the
    identity on one process."""
    if setup.lay is None:
        return t
    v = t.unflatten(-1, (-1, setup.n_loc))
    return _gather_shards(setup, v, v.dim() - 2).flatten(-2)


def _local_valid(setup: SolverSetup):
    """Which of this rank's slots hold a row index below n, (n_pad_loc,)
    bool — the validity the shrink mask and the active count AND in."""
    if setup.lay is None:
        return torch.arange(setup.n_pad, device=setup.device) < setup.n
    return torch.cat([
        torch.arange(s * setup.n_loc, (s + 1) * setup.n_loc,
                     device=setup.device) for s in setup.local]) < setup.n


def _real_rows(t, segs):
    """The real rows of a padded (…, n_pad) tensor in the user's order:
    its last dimension's runs ``segs`` (a view where there is one run;
    ``t`` itself for None)."""
    if segs is None:
        return t
    if len(segs) == 1:
        start, _, c = segs[0]
        return t[..., start:start + c]
    return torch.cat([t[..., a:a + c] for a, _, c in segs], dim=-1)


def _place_labels(y, *, n: int, n_pad: int, device, segs, place=None):
    """The (K, n) ±1 label matrix placed into the solve's row layout, the
    padding rows +1 (inert: their rows are zero and outside every sum;
    the fold only has to stay finite).  Returns (K, the (K, n_pad)
    float32 labels on ``device``); ``place(t, fill)`` places the rows
    instead where the layout is a rank's."""
    Y = (y.to(device, torch.float32) if torch.is_tensor(y)
         else torch.tensor(np.asarray(y, np.float32), device=device))
    if Y.dim() != 2 or Y.shape[1] != n:
        raise ValueError(f"label matrix has shape {tuple(Y.shape)} for "
                         f"{n} rows")
    K = int(Y.shape[0])
    rows = (_place_rows(Y.T, n_pad, segs, 1.0) if place is None
            else place(Y.T, 1.0))
    return K, rows.T.contiguous()


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
    ``pipeline=False`` keeps the reference's own ``ValueError``s (a
    multi-task ``y``, a pod axis, shrinking or the adaptive delay), and
    the self-tuning knobs are validated by ``resolve_self_tuning``.

    On a mesh spread over ranks (``rank_layout``) only this rank's part
    is placed: the rows (labels, norms) of its data shards and, on the
    2-D mesh, its feature shards of them, split a row chunk at a time
    (``_split_local``), never the whole split."""
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
    _reject_unported(mesh=mesh)
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
    lay = rank_layout(mesh)
    if two_d:
        # across ranks a dense X converts on the host and stays there
        ell_m = (X_host if ell else dense_to_ell(
            X_host, device=dev if lay is None else "cpu"))
        if lay is None:
            ell_m = ell_m.to(dev)
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
    if lay is None:
        def place(t, fill):
            return _place_rows(t, n_pad, segs, fill)
        ranks = {}
    else:
        local = _local_shards(lay, p, pods)
        runs = _local_runs(segs, local, n_loc)

        def place(t, fill, dtype=None):
            return _place_local(t, len(local) * n_loc, runs, fill, dev,
                                dtype)

        def row_norms(v):
            """‖x_i‖² of the placed rows, the padding slots 1."""
            q = torch.sum(v * v, dim=tuple(range(1, v.dim())))
            return _place_local(q, q.shape[0], [(a, a, c)
                                                for a, _, c in runs], 1.0,
                                dev)
        ranks = dict(lay=lay, local=local, segs_loc=runs)
    if two_d:
        d = ell_m.n_features
        m = mesh.shape["model"]
        if lay is None:
            fse = ell_column_split(
                EllMatrix(ell_m.indices.to(torch.int32),
                          ell_m.values.to(torch.float32), d), m)
            del ell_m
            X = (place(fse.indices, fse.d_loc), place(fse.values, 0.0))
            sq_norms = place(fse.row_sq_norms(), 1.0)
            d_loc = fse.d_loc
        else:
            span = lay.span("model", m)
            X, sq_norms, d_loc = _split_local(
                EllMatrix(ell_m.indices.to(torch.int32),
                          ell_m.values.to(torch.float32), d), m, span, runs,
                len(local) * n_loc, dev)
            del ell_m
            ranks["m_here"] = span[1]
        w_shape = (ranks.get("m_here", m), d_loc + 1)
        extra = dict(m=m, d_loc=d_loc)
    elif ell and lay is not None:
        d = X_host.n_features
        X = (place(X_host.indices, d, torch.int32),
             place(X_host.values, 0.0, torch.float32))
        sq_norms = row_norms(X[1])
        w_shape, extra = (d + 1,), {}
    elif ell:
        d = X_host.n_features
        cols = X_host.indices.to(dev, torch.int32).contiguous()
        vals = X_host.values.to(dev, torch.float32).contiguous()
        sq_norms = place(torch.sum(vals * vals, dim=1), 1.0)
        X = (place(cols, d), place(vals, 0.0))
        w_shape, extra = (d + 1,), {}
    elif lay is not None:
        X = place(torch.as_tensor(X_host), 0.0, torch.float32)
        d = X.shape[1]
        sq_norms = row_norms(X)
        w_shape, extra = (d,), {}
    else:
        X = torch.as_tensor(X_host, dtype=torch.float32,
                            device=dev).contiguous()
        d = X.shape[1]
        sq_norms = place(torch.sum(X * X, dim=1), 1.0)
        X = place(X, 0.0)
        w_shape, extra = (d,), {}
    if ell or two_d:
        cols = X[0]
        lim = extra.get("d_loc", d)
        if not (0 <= int(cols.min()) and int(cols.max()) <= lim):
            raise ValueError(f"ELL column ids must lie in [0, {lim}]")
    if y is not None:
        extra["n_tasks"], extra["Y"] = _place_labels(
            y, n=n, n_pad=n_pad, device=dev, segs=segs,
            place=None if lay is None else place)
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
        pod_delay_rounds=int(pod_delay_rounds), segs=segs, **extra,
        **ranks)


def _init_alpha_w(setup: SolverSetup, alpha0=None, w0=None):
    """(α (K, n_pad), w (K, *w_shape)) for a solve — zeros, or a warm
    start from carried state: a (K, n')/(K, d') stack on a multi-task
    solve, an (n',)/(d',) one on a binary solve (K = 1).  A carried
    state *shorter* than n/d is the streaming-append warm start: old
    coordinates keep their values, new ones start at 0.  On a pod mesh
    α0 lands in each pod's rows, whatever pod count it was carried
    from; on a 2-D mesh each task's w0 is re-blocked onto the shards'
    slices.  Across ranks α holds this rank's rows and w its feature
    shards' slices."""
    dev, K = setup.device, setup.K
    alpha = torch.zeros((K, setup.n_pad_loc), dtype=torch.float32,
                        device=dev)
    if alpha0 is not None:
        a0 = torch.as_tensor(alpha0, dtype=torch.float32,
                             device=dev).reshape(K, -1)[:, :setup.n]
        for start, src, c in (setup.segs_loc if setup.lay else setup.segs):
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
            w[:, :, :setup.d_loc] = flat.view(K, setup.m, setup.d_loc)[
                :, setup.m0:setup.m0 + setup.m_loc]
        else:
            w[:, :v0.shape[1]] = v0
    return alpha, w


def _finalize(setup: SolverSetup, alpha, w, gaps, epochs, eps=None,
              active=None, delay=None):
    """Back to user coordinates: drop the padding rows (a pod layout's
    real rows are its runs ``segs``) and the dummy slot, on a 2-D mesh
    stitch ŵ out of the shards' slices, task by task; a binary solve
    drops the task dimension.  Across ranks α is gathered over ``data``
    and ``pod`` and the slices over ``model`` first, so every rank
    returns the whole result (the records are every rank's already)."""
    K = setup.K
    alpha = _gather_rows(setup, alpha)
    if setup.two_d:
        w = gather_axis(w, setup.lay, "model", 1)
        w = w[:, :, :setup.d_loc].reshape(K, -1)
    out = (_real_rows(alpha, setup.segs), w[:, :setup.d], gaps, eps, active,
           delay)
    if not setup.n_tasks:
        out = tuple(None if t is None else t[0] for t in out)
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


def _reject_unported(*, mesh):
    """The mesh axes the solver runs on; any other layout raises."""
    axes = tuple(mesh.axis_names)
    if axes not in (("data",), ("data", "model"), ("task", "data"),
                    ("task", "data", "model"), ("pod", "data"),
                    ("pod", "data", "model")):
        raise ValueError(f"mesh axes {axes}: the solver runs on ('data',) "
                         "or ('data', 'model'), with or without a leading "
                         "'task' or 'pod'")


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


def _block_draw(setup: SolverSetup, blocks, total: int):
    """``draw(e, sub, act=None, rp=None)``: global epoch e's (n_blocks,
    p, B) shard-local ids, round-major — from ``blocks`` (indexed by the
    global epoch; an epoch past the schedule repeats its last one: only
    the overlapped round's peek past the final epoch asks, and discards
    it) or from the epoch subkey ``sub`` of the reference's key chain
    (``PRNGKey(seed)`` then per epoch ``key, sub = split(key)``, carried
    in the state): one chain for every task, so each task draws its own
    binary solve's blocks.  With the tasks' active masks ``act``
    (K, n_pad) and repack flags ``rp`` (K,) the draw is the masked one
    (``_device_block_perm_masked``), each task's own: (n_blocks, K, p,
    B).  On a pod mesh shard s is the fleet index k·p_pod + my of P·p_pod
    split keys, with its pod's own valid count (``_shard_valid``).
    Across ranks each rank draws its own shards' blocks from the same
    key chain (the p of the ids' shape is then this rank's); nothing is
    communicated."""
    p, n_loc, nb, B = (setup.p, setup.n_loc, setup.n_blocks,
                       setup.block_size)
    shards = list(setup.local or range(p))  # a rank draws its own shards'
    if blocks is not None:
        blocks = _as_blocks(blocks, setup, total)
        if setup.local:
            blocks = blocks[:, shards]
        return lambda e, sub, act=None, rp=None: (
            blocks[min(e, total - 1)].transpose(0, 1).contiguous())
    valid = _shard_valid(setup)

    def draw(e, sub, act=None, rp=None):
        if act is None:
            per = [_device_block_perm_v(sub, my, p, n_loc, valid[my], nb, B)
                   for my in shards]
            return torch.stack(per, dim=1)  # (n_blocks, p, B)
        acts = act.reshape(act.shape[0], len(shards), n_loc)
        per = [_device_block_perm_masked(sub, my, p, n_loc, nb, B,
                                         acts[:, j], rp)
               for j, my in enumerate(shards)]  # each (K, n_blocks, B)
        return torch.stack(per, dim=2).transpose(0, 1).contiguous()

    return draw


def _gram_workspaces(cols, block_size: int, d1: int, p: int, K: int,
                     overlap: bool, m_all: int = 0):
    """B4's workspaces on the card for blocks of ``block_size`` ids over
    the (n, m, k) slices ``cols``: one for the eager round, two that
    alternate for the overlapped one (B4 of block t + 1 runs before B5
    of block t, which reads block t's buckets); None on the CPU.
    ``m_all``: the mesh's feature shards where ``cols`` holds a rank's."""
    if not cols.is_cuda:
        return (None, None)
    return tuple(gram_workspace(cols.shape[1], block_size, cols.shape[2],
                                d1, cols.device, p, K, m_all)
                 for _ in range(2 if overlap else 1))


def _workspaces(setup: SolverSetup):
    """The solve's B4 workspaces (``_gram_workspaces``) for the fused
    engine; None for the unfused one."""
    if not setup.fused:
        return (None, None)
    return _gram_workspaces(setup.X[0], setup.block_size, setup.w_shape[1],
                            setup.p_loc, setup.K, setup.overlap, setup.m)


def pipeline_state_keys(*, dyn: bool, shrink_on: bool, adaptive: bool,
                        pod_fifo: int, watchdog: bool):
    """The key set of the solver's carried state (``SolverState``, the
    reference's names) for a knob combination — the checkpoint schema.
    ``inflight`` is absent on purpose: the overlapped round's in-flight
    (base, Gram) is a function of the carried (w, key) and is rebuilt at
    segment entry."""
    keys = ["alpha", "w", "dw", "key", "gaps", "epsb", "actb", "delayb",
            "slot", "epoch"]
    if dyn:
        keys.append("dwo")
    if shrink_on:
        keys += ["act", "frac", "nrun", "rp"]
    if adaptive:
        keys += ["delay", "gapprev"]
        if shrink_on:
            keys.append("rpok")
    if pod_fifo:
        keys.append("pbuf")
    if watchdog:
        keys += ["health", "gph", "eph"]
    return keys


# the host-driven counters of the state: the host runs the epoch loop, so
# the epoch and the record slot live on its side and cost no device read
_HOST_KEYS = ("epoch", "slot")


class _Knobs(NamedTuple):
    """A segment's effective asynchrony (the solve's own, or a rung of
    ``degrade_ladder``) and the round scan it selects."""

    delay_rounds: int
    pod_delay_rounds: int
    overlap: bool
    dyn: bool  # the self-tuning round scan
    delay0: int  # the delay flag's start
    pod_fifo: int  # the pod merge FIFO's length (0: none)


def _segment_knobs(setup: SolverSetup, delay_rounds=None,
                   pod_delay_rounds=None, overlap_on=None) -> _Knobs:
    """The reference's mode resolution for a segment built with the
    given overrides: the overlapped round needs the solve's own overlap
    and ``delay_rounds ≥ 1`` (a segment may only turn it off), the
    self-tuning scan runs where neither the overlap nor a pod axis does,
    and the delay flag starts at the inner delay — on a pod mesh at
    whether the pod merge starts delayed."""
    dr = setup.delay_rounds if delay_rounds is None else int(delay_rounds)
    pdr = (setup.pod_delay_rounds if pod_delay_rounds is None
           else int(pod_delay_rounds))
    ov = setup.overlap and (overlap_on is None or bool(overlap_on))
    ov = ov and dr >= 1
    tn = setup.tuning
    dyn = (tn.shrink_every > 0 or tn.adaptive) and not ov and not setup.pod_on
    delay0 = int(pdr > 0) if setup.pod_on else dr
    pod_fifo = pdr if (setup.pod_on and pdr > 0) else 0
    return _Knobs(dr, pdr, ov, dyn, delay0, pod_fifo)


def init_pipeline_state(setup: SolverSetup, *, total_epochs: int,
                        watchdog: bool = False, alpha0=None, w0=None,
                        delay_rounds=None, pod_delay_rounds=None,
                        overlap_on=None) -> dict:
    """The epoch-0 ``SolverState`` of a ``total_epochs`` solve: a flat
    dict with ``pipeline_state_keys``' names, every leaf with the leading
    task dimension K (K = 1 on a binary solve) except ``epoch``.  α and w
    are zeros or the warm start ``alpha0``/``w0`` re-blocked onto this
    setup's layout (``_init_alpha_w``, the elastic restore's path too);
    ``dwo`` is (K, p, *w), a shard's own last-round Δw, and ``pbuf`` the
    pod FIFO (K, delay, *w).  The override knobs are a degraded
    segment's (``degrade_ladder``)."""
    kn = _segment_knobs(setup, delay_rounds, pod_delay_rounds, overlap_on)
    tn, dev, K = setup.tuning, setup.device, setup.K
    f32, i32 = torch.float32, torch.int32
    n_gaps = (_gap_slots(int(total_epochs), setup.gap_every)
              if setup.record else 0)
    alpha, w = _init_alpha_w(setup, alpha0, w0)
    st = {"alpha": alpha, "w": w, "dw": torch.zeros_like(w),
          "key": prng.PRNGKey(setup.seed, device=dev).expand(K, 2).clone(),
          "slot": torch.zeros((K,), dtype=i32),
          "epoch": torch.zeros((), dtype=i32)}
    for k in ("gaps", "epsb", "actb", "delayb"):
        st[k] = torch.zeros((K, n_gaps), dtype=f32, device=dev)
    if kn.dyn:
        st["dwo"] = torch.zeros((K, setup.p_loc, *setup.w_shape),
                                dtype=f32, device=dev)
    if tn.shrink_every > 0:
        st["act"] = _local_valid(setup).expand(K, -1).clone()
        st["frac"] = torch.ones((K,), dtype=f32, device=dev)
        st["nrun"] = torch.full((K,), setup.n_blocks, dtype=i32, device=dev)
        st["rp"] = torch.zeros((K,), dtype=torch.bool, device=dev)
    if tn.adaptive:
        st["delay"] = torch.full((K,), kn.delay0, dtype=i32, device=dev)
        st["gapprev"] = torch.full((K,), float("inf"), device=dev)
        if tn.shrink_every > 0:
            st["rpok"] = torch.ones((K,), dtype=i32, device=dev)
    if kn.pod_fifo:
        st["pbuf"] = torch.zeros((K, kn.pod_fifo, *setup.w_shape),
                                 dtype=f32, device=dev)
    if watchdog:
        st["health"] = torch.zeros((K,), dtype=i32, device=dev)
        st["gph"] = torch.full((K,), float("inf"), device=dev)
        st["eph"] = torch.full((K,), float("inf"), device=dev)
    return st


_ROW_KEYS = ("alpha", "act")  # (K, n_pad): a row each
_PRIMAL_KEYS = ("w", "dw", "dwo", "pbuf")  # (…, *w): on 2-D, m slices


def state_to_global(setup: SolverSetup, state: dict) -> dict:
    """A rank's ``SolverState`` gathered into the one-process layout of
    the whole mesh (every rank takes part and gets it): α and the
    shrink mask over ``data``/``pod``, a shard's own Δw (``dwo``) too,
    and on the 2-D mesh every primal leaf's slices over ``model``.  The
    other leaves are every rank's already.  The state itself on one
    process."""
    if setup.lay is None:
        return state
    out = dict(state)
    for k, v in state.items():
        if k in _ROW_KEYS:
            out[k] = _gather_rows(setup, v)
            continue
        if k == "dwo":
            v = _gather_shards(setup, v, 1)
        if k in _PRIMAL_KEYS and setup.two_d:
            v = gather_axis(v, setup.lay, "model", v.dim() - 2)
        out[k] = v
    return out


def state_to_local(setup: SolverSetup, state: dict) -> dict:
    """The inverse of ``state_to_global``: this rank's part of a
    one-process ``SolverState`` (α's and the mask's rows of its shards,
    ``dwo``'s shards, its feature shards' slices)."""
    if setup.lay is None:
        return state
    dev, n_loc = setup.device, setup.n_loc
    rows = torch.cat([torch.arange(s * n_loc, (s + 1) * n_loc)
                      for s in setup.local]).to(dev)
    out = dict(state)
    for k, v in state.items():
        if k in _ROW_KEYS:
            out[k] = v[..., rows].contiguous()
            continue
        if k == "dwo":
            v = v[:, list(setup.local)]
        if k in _PRIMAL_KEYS and setup.two_d:
            v = v.narrow(v.dim() - 2, setup.m0, setup.m_loc)
        out[k] = v.contiguous()
    return out


def global_setup(setup: SolverSetup) -> SolverSetup:
    """The setup's description of the whole mesh on one process (its
    sizes and layout, no rank part; the placed tensors are still this
    rank's): what the checkpoint's conversions read."""
    if setup.lay is None:
        return setup
    w_shape = ((setup.m, setup.w_shape[1]) if setup.two_d
               else setup.w_shape)
    return setup._replace(lay=None, local=(), segs_loc=(), m_here=0,
                          w_shape=w_shape)


def device_put_state(setup: SolverSetup, state: dict) -> dict:
    """A ``SolverState`` placed for ``setup``: every leaf on its device,
    the host-driven counters (``epoch``, ``slot``) on the host.  On one
    card this is the whole of the reference's re-sharding point: a
    restored state's leaves land here in the port's layout."""
    cpu = torch.device("cpu")
    return {k: v.to(cpu if k in _HOST_KEYS else setup.device)
            for k, v in state.items()}


def finalize_state(setup: SolverSetup, state: dict, *,
                   epochs: int) -> ShardedResult:
    """A ``ShardedResult`` out of a ``SolverState``: the in-flight
    aggregate flushed — the pod FIFO drained, or the delayed round's Δw
    (zeros when the run ended synchronous) — and the padding and dummy
    slots dropped (``_finalize``)."""
    tn, w = setup.tuning, state["w"]
    if "pbuf" in state:
        w = w + state["pbuf"].sum(1)
    elif (setup.delay_rounds > 0 or tn.shrink_every or tn.adaptive
          or setup.pod_delay_rounds > 0):
        w = w + state["dw"]
    return _finalize(setup, state["alpha"], w, state["gaps"], epochs,
                     state["epsb"], state["actb"], state["delayb"])


def _check_pipeline_chaos(*, record, watchdog, fault, pod_on):
    """The resilience knobs, the reference's checks: the watchdog reads
    the records, and the drop and dup faults hit the cross-pod merge."""
    if watchdog and not record:
        raise ValueError(
            "watchdog=True requires record=True: the divergence test "
            "keys on the recorded gap/eps schedule")
    if fault is None:
        return None
    fault = tuple(int(v) for v in fault)
    if len(fault) != 3:
        raise ValueError("fault must be (nan_epoch, drop_epoch, "
                         "dup_epoch), -1 disabling each")
    if not pod_on and (fault[1] >= 0 or fault[2] >= 0):
        raise ValueError(
            "drop/dup merge faults target the cross-pod merge and need "
            "a pod mesh; on a single-pod mesh only the NaN-psum fault "
            "is meaningful")
    return fault


def _merge_fault(fault, e: int):
    """The armed faults of epoch ``e``'s cross-pod merge g, in the
    reference's order (NaN, drop, dup), as a function of g; None when
    none is armed there."""
    if fault is None or e not in fault:
        return None
    nan_e, drop_e, dup_e = fault

    def hit(g):
        if e == nan_e:
            g = g + float("nan")
        if e == drop_e:
            g = g * 0.0
        if e == dup_e:
            g = g * 2.0
        return g

    return hit


def _bad_count(alpha, w_view, lay=None):
    """The watchdog's census: each task's count of non-finite entries
    of α and of the primal view, (K,).  Across ranks it is the int64
    SUM of every rank's count (a replicated ŵ counted on each), so the
    watchdog trips on every rank at once."""
    K = alpha.shape[0]
    return sum_int((~torch.isfinite(alpha)).sum(1)
                   + (~torch.isfinite(w_view)).reshape(K, -1).sum(1), lay)


def _make_gap(setup: SolverSetup, X):
    """The record's gap closure (``_gap_closure``) over the dataset
    ``X`` in the setup's layout: ``gap(α, ŵ, y)`` over this rank's
    padded rows, summed over the real rows of the whole solve."""
    lay = setup.lay
    runs = setup.segs_loc if lay is not None else setup.segs
    spread = None
    if lay is not None:
        def spread(t):
            """A rank's real-row terms to the whole solve's real rows,
            in the user's order."""
            full = t.new_zeros((setup.n_pad_loc,))
            j = 0
            for a, _, c in runs:
                full[a:a + c] = t[j:j + c]
                j += c
            return _real_rows(_gather_rows(setup, full), setup.segs)
    return _gap_closure(setup.loss, X, ell=setup.ell, two_d=setup.two_d,
                        runs=runs, lay=lay, spread=spread)


def _engines(setup: SolverSetup, X, workspaces, overlap: bool):
    """A segment's closures over the dataset ``X`` (``setup.X``, or a
    copy the fault harness poisoned): the round's block engine, the
    overlapped round's split phases, the record's gap and the shrink
    mask with the rows' validity."""
    overlap_fns = None
    if setup.two_d:
        cols, vals = X
        gather = _model_gather(setup.lay, setup.m)
        engine = functools.partial(
            _block_update_2d(setup.loss, setup.fused, workspaces[0],
                             setup.n_loc, setup.Y, gather),
            cols, vals, setup.sq_norms)
        if overlap:
            overlap_fns = _overlap_round_fns(cols, vals, setup.sq_norms,
                                             setup.loss, setup.n_loc,
                                             setup.Y, gather)
    else:
        engine = functools.partial(
            _block_update_1d(setup.loss, setup.ell, setup.n_loc, setup.Y),
            X, setup.sq_norms)
    gap = _make_gap(setup, X)
    shrink = _make_shrink(setup, X) if setup.tuning.shrink_every else None
    return engine, overlap_fns, gap, shrink


def build_pipeline(setup: SolverSetup, *, epochs: int,
                   total_epochs: int | None = None, blocks=None,
                   watchdog: bool = False, watchdog_blowup: float = 4.0,
                   watchdog_floor: float = 1e-3, fault=None,
                   delay_rounds=None, pod_delay_rounds=None,
                   overlap_on=None):
    """The segment runner: ``run(X, state) → state`` advances a
    ``SolverState`` by ``epochs`` epochs of a ``total_epochs`` schedule,
    from the global epoch ``state["epoch"]`` (``_epoch_scan``), so chained
    segments are the whole solve bit for bit.  ``X`` is ``setup.X`` or a
    poisoned copy of it.  ``watchdog`` adds the sticky health code;
    ``fault`` is the (nan_epoch, drop_epoch, dup_epoch) triple (−1 off,
    global epochs); ``delay_rounds``/``pod_delay_rounds``/``overlap_on``
    override the setup's knobs for a degraded retry.  ``blocks=`` is an
    explicit schedule of all ``total_epochs`` epochs."""
    total = int(epochs if total_epochs is None else total_epochs)
    kn = _segment_knobs(setup, delay_rounds, pod_delay_rounds, overlap_on)
    fault = _check_pipeline_chaos(record=setup.record, watchdog=watchdog,
                                  fault=fault, pod_on=setup.pod_on)
    draw = _block_draw(setup, blocks, total)
    workspaces = _workspaces(setup) if setup.two_d else None
    wd = (float(watchdog_blowup), float(watchdog_floor)) if watchdog else None

    def run(X, state):
        e0 = int(state["epoch"])
        if e0 + epochs > total:
            raise ValueError(f"a segment of {epochs} epochs from epoch "
                             f"{e0} runs past the schedule's {total}")
        engine, overlap_fns, gap, shrink = _engines(setup, X, workspaces,
                                                    kn.overlap)
        return _epoch_scan(setup, state, e0=e0, epochs=epochs, total=total,
                           kn=kn, engine=engine, gap=gap, draw=draw,
                           shrink=shrink, overlap_fns=overlap_fns,
                           workspaces=workspaces, watchdog=wd, fault=fault)

    return run


def _epoch_scan(setup: SolverSetup, state: dict, *, e0: int, epochs: int,
                total: int, kn: _Knobs, engine, gap, draw, shrink=None,
                overlap_fns=None, workspaces=None, watchdog=None,
                fault=None) -> dict:
    """The epoch loop (the reference's ``_epoch_scan`` under its task
    vmap) over the global epochs e0 … e0 + epochs − 1 of a ``total``
    schedule, from and to a ``SolverState``: split the carried key, draw
    each epoch's blocks, run its rounds — the static ``_scan_rounds``,
    the self-tuning ``_scan_rounds_dyn`` or the overlapped
    ``_scan_rounds_overlap`` (whose in-flight aggregate crosses epochs
    and is rebuilt at entry from the carried (w, key) through the peek of
    the next draw) — and record each task's gap, ‖w(α) − ŵ‖, active
    fraction and delay flag into the (K, slots) device buffers.  Every
    decision keys on the global epoch: the record slots, the shrink
    schedule, the final unshrunk epoch and the armed faults.  Shrinking
    recomputes each task's mask every ``shrink_every`` epochs (the final
    epoch runs unshrunk); repacking draws a task's epoch over its
    compacted active set when its fraction, summed over the shards, is
    below the threshold, and that task runs as many rounds as its
    largest shard's count needs.  The tasks' counts are read on the host
    together, once an epoch, the solve's only sync besides the
    watchdog's once a segment (counted in
    ``sharded_passcode_solve.host_reads``): the epoch runs the largest,
    a task past its own keeping its state.  The rounds run per epoch are
    appended to ``sharded_passcode_solve.epoch_rounds`` and each task's
    to ``task_rounds``.  The adaptive delay lowers each task's device
    flag at records (one-way), and with shrinking a hard stall turns that
    task's repacking off for good.  On a pod mesh every epoch is the
    Hybrid-DCA outer round (``_pod_epoch``), the adaptive flag the pod
    FIFO's latch.  ``watchdog`` ((blowup, floor)) folds each record's
    ``watchdog_trip`` code into the sticky (K,) ``health``, the healthy
    baselines ``gph``/``eph`` advancing on clean records only;
    ``fault``'s NaN poisons w after the rounds on one pod, and on a pod
    mesh the faults hit the merge g before the FIFO.  The state handed
    in is not modified."""
    c = dict(state)
    tn, K = setup.tuning, setup.K
    lay, dp = setup.lay, ("pod", "data")
    solve = sharded_passcode_solve
    shrink_on, adaptive = tn.shrink_every > 0, tn.adaptive
    alpha, w, dw = c["alpha"], c["w"], c["dw"]
    dwo, fifo = c.get("dwo"), c.get("pbuf")
    key = c["key"][0]  # the tasks share one chain
    # the record buffers are written in place: copies, so a rollback's
    # snapshot of the state handed in stays as it was
    recs = {k: c[k].clone() for k in ("gaps", "epsb", "actb", "delayb")}
    slot = int(c["slot"][0])
    if shrink_on:
        mask_fn, valid = shrink
        act, frac, nrun, rp = c["act"], c["frac"], c["nrun"], c["rp"]
    if adaptive:
        delay, gapprev, rpok = c["delay"], c["gapprev"], c.get("rpok")
    if watchdog is not None:
        health, gph, eph = c["health"], c["gph"], c["eph"]
    inflight = None
    if kn.overlap:
        # the in-flight (base, Gram) the previous epoch issued for this
        # one's first block, against the carried w: the draw's peek
        sub0 = prng.split(key)[1]
        first = (draw(e0, sub0, valid.expand(K, -1), torch.zeros_like(rp))
                 if shrink_on else draw(e0, sub0))[0]
        inflight = (*overlap_fns[0](w, first, workspaces[0]),
                    workspaces[0])
    for e in range(e0, e0 + epochs):
        key, sub = prng.split(key)
        final = e == total - 1
        n_run, act_run, runs, n_all = setup.n_blocks, None, None, 0
        if shrink_on:
            if e % tn.shrink_every == 0:
                act = mask_fn(alpha, w + dw)
                cnt = act.view(K, setup.p_loc, setup.n_loc).sum(2)
                # across ranks: the active count's int64 SUM and the
                # largest shard's count's MAX, the same on every rank
                frac = sum_int(cnt.sum(1), lay, dp).float() / setup.n
                if tn.repack:
                    rp = frac < setup.repack_threshold
                    nrun = torch.clamp(
                        -(-max_all(cnt.max(1).values, lay, dp)
                          // setup.block_size), 1,
                        setup.n_blocks).to(torch.int32)
            act_run = (valid if final else act).float()
            use_rp = rp & (not final)
            if adaptive:
                use_rp = use_rp & (rpok > 0)
            blocks = draw(e, sub, torch.where(use_rp[:, None], act, valid),
                          use_rp)
            if tn.repack:
                # the tasks' round counts, read on the host together: one
                # sync an epoch, and none a round
                runs = torch.where(use_rp, nrun, setup.n_blocks)
                counts = runs.tolist()
                solve.host_reads += 1
                n_run, n_all = max(counts), min(counts)
                solve.task_rounds.append(counts)
        else:
            blocks = draw(e, sub)
        if runs is None:
            solve.task_rounds.append([n_run] * K)
        solve.epoch_rounds.append(n_run)
        delay_flag = delay if adaptive else kn.delay0
        if setup.pod_on:
            alpha, w, fifo = _pod_epoch(
                setup, engine, alpha, w, blocks, fifo,
                delay if adaptive else None, delay_rounds=kn.delay_rounds,
                pod_delay_rounds=kn.pod_delay_rounds,
                hit=_merge_fault(fault, e))
        elif kn.overlap:
            sub_next = prng.split(key)[1]  # the next epoch's subkey
            nxt = (draw(e + 1, sub_next, valid.expand(K, -1),
                        torch.zeros_like(rp))
                   if shrink_on else draw(e + 1, sub_next))[0]
            alpha, w, dw, inflight = _scan_rounds_overlap(
                *overlap_fns, alpha, w, dw, blocks, inflight, nxt,
                workspaces, act_run, lay)
        elif kn.dyn:
            alpha, w, dw, dwo = _scan_rounds_dyn(
                engine, alpha, w, dw, dwo, blocks, act_run, n_run,
                delay_flag, runs if n_all < n_run else None, n_all, lay)
        else:
            alpha, w, dw = _scan_rounds(engine, alpha, w, dw, blocks,
                                        kn.delay_rounds, lay=lay)
        if fault is not None and not setup.pod_on and e == fault[0]:
            w = w + float("nan")  # a poisoned psum reaching w
        if setup.record and ((e + 1) % setup.gap_every == 0 or final):
            w_view = w + dw
            g, eps = _task_gaps(gap, alpha, w_view, setup.Y)
            recs["gaps"][:, slot], recs["epsb"][:, slot] = g, eps
            recs["actb"][:, slot] = frac if shrink_on else 1.0
            recs["delayb"][:, slot] = delay_flag
            if adaptive:
                # each task's gap-trend controller, through a one-way latch
                new_flag = adaptive_delay_policy(
                    gapprev, g, improve_ratio=setup.adaptive_ratio)
                delay = torch.minimum(delay_flag, new_flag)
                if shrink_on:
                    # the sticky repack guard keys on a hard stall
                    rpok = rpok * adaptive_delay_policy(gapprev, g)
                gapprev = g
            if watchdog is not None:
                code = watchdog_trip(gph, g, eph, eps,
                                     _bad_count(alpha, w_view, lay),
                                     blowup=watchdog[0], floor=watchdog[1])
                ok = code == 0
                health = torch.maximum(health, code)
                gph, eph = torch.where(ok, g, gph), torch.where(ok, eps, eph)
            slot += 1
    c.update(recs, alpha=alpha, w=w, dw=dw, key=key.expand(K, 2).clone(),
             slot=torch.full((K,), slot, dtype=torch.int32),
             epoch=torch.tensor(e0 + epochs, dtype=torch.int32))
    if dwo is not None:
        c["dwo"] = dwo
    if fifo is not None:
        c["pbuf"] = fifo
    if shrink_on:
        c.update(act=act, frac=frac, nrun=nrun, rp=rp)
    if adaptive:
        c.update(delay=delay, gapprev=gapprev)
        if rpok is not None:
            c["rpok"] = rpok
    if watchdog is not None:
        c.update(health=health, gph=gph, eph=eph)
    return c


def _pod_epoch(setup: SolverSetup, engine, alpha, w, blocks, fifo,
               latch=None, *, delay_rounds: int, pod_delay_rounds: int,
               hit=None):
    """One Hybrid-DCA outer round (the reference's pod branch of
    ``_epoch_scan``): from the merged snapshot (α₀, w₀) every pod runs
    its epoch's rounds on its own view of w, from a zero Δw carry, and
    flushes its in-flight inner Δw into Δw_pod = (w₁ + Δw_in) − w₀; α
    moves by 1/P of each pod's progress (its rows are its own), and
    g = (1/P)·Σ_pods Δw_pod, summed in pod order, lands now
    (``pod_delay_rounds`` 0) or enters the FIFO (K, delay, *w) while its
    head lands.  ``latch`` (the adaptive delay's (K,) flags) drains a
    task's whole FIFO and merges synchronously once its flag is 0.
    ``hit`` (the fault harness) rewrites g before the FIFO.  At P = 1 the
    merge's scale is 1 and the pod's own α₁ stands (and, at delay 0 and
    with no fault, w₁): the identity without the round trip's rounding.
    Across ranks a rank runs its own pods (views (K, P_loc, *w)).
    Returns (α, w, FIFO)."""
    P, K = setup.pods, alpha.shape[0]
    a0, w0 = alpha, w
    wv = (w0 if P == 1
          else w0[:, None].expand(K, setup.pods_loc, *w0.shape[1:]))
    a1, w1, dwi = _scan_rounds(engine, a0, wv.contiguous(),
                               torch.zeros_like(wv), blocks, delay_rounds,
                               P, setup.lay)
    if delay_rounds > 0:
        w1 = w1 + dwi  # the pod's inner rounds end synchronous
    if P == 1:
        alpha, g = a1, w1 - w0
    else:
        scale = 1.0 / P
        alpha = a0 + scale * (a1 - a0)  # a pod's rows are its own
        # across ranks the pods' Δw_pod are gathered over ``pod`` first
        g = scale * gather_axis(w1 - w0[:, None], setup.lay, "pod", 1).sum(1)
    if hit is not None:
        g = hit(g)
    if not pod_delay_rounds:
        return alpha, (w1 if P == 1 and hit is None else w0 + g), fifo
    w_async = w0 + fifo[:, 0]
    fifo_async = torch.cat([fifo[:, 1:], g[:, None]], 1)
    if latch is None:
        return alpha, w_async, fifo_async
    sync = (latch == 0).view(K, *(1,) * (w0.dim() - 1))
    w = torch.where(sync, w0 + fifo.sum(1) + g, w_async)
    fifo = torch.where(sync[:, None], torch.zeros_like(fifo), fifo_async)
    return alpha, w, fifo


def solver_mouth(X_host, loss, *, y=None, device=None,
                 pipeline: bool = True, **knobs) -> SolverSetup:
    """The solve's inputs validated and placed (``prepare_solver``) on
    ``device``, the card by default: (n,) ±1 labels ``y`` are checked
    and folded into X; a (K, n) ``y`` is the multi-task solve's label
    matrix, checked and kept apart.  ``knobs`` are
    ``prepare_solver``'s."""
    dev = resolve_device(device)
    # a (K, n) label matrix is the multi-task solve: not folded into X
    multitask = y is not None and len(getattr(y, "shape", ())) == 2
    mesh = _resolve_mesh(knobs.get("mesh"), knobs.get("mesh_axes",
                                                      ("data",)))
    # across ranks X stays where it lies: ``prepare_solver`` copies only
    # this rank's rows (on the 2-D mesh its feature shards of them) to
    # the card
    stay = rank_layout(mesh) is not None
    if isinstance(X_host, EllMatrix):
        X_host = X_host if stay else X_host.to(dev)
    else:
        X_host = torch.as_tensor(X_host, dtype=torch.float32,
                                 device=None if stay else dev)
    if multitask:
        y = _validate_multitask_labels(X_host, y)
        X_host = _validate_solver_inputs(X_host, None, loss)
        if not pipeline:
            raise ValueError(
                "a multi-task solve needs pipeline=True (see "
                "repro_torch.dist.mesh.task_axis_policy)")
    else:
        X_host = _validate_solver_inputs(X_host, y, loss)
    return prepare_solver(X_host, loss, y=y if multitask else None,
                          pipeline=pipeline, device=dev, **knobs)


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
    carried from any pod count warm-start it.  ``pipeline=False`` runs
    the per-epoch host driver (``_drive_epochs`` over
    ``make_sharded_epoch`` or ``make_sharded_epoch_2d``: the same key
    chain, so the same update sequence; gaps only, no ``eps``); with a
    multi-task ``y``, a pod axis, shrinking or the adaptive delay it
    raises the reference's ``ValueError``.
    """
    setup = solver_mouth(
        X_host, loss, y=y, device=device, mesh=mesh, mesh_axes=mesh_axes,
        block_size=block_size, delay_rounds=delay_rounds,
        pod_delay_rounds=pod_delay_rounds, seed=seed, record=record,
        use_kernel=use_kernel, gap_every=gap_every, pipeline=pipeline,
        overlap=overlap, shrink_every=shrink_every, shrink_tol=shrink_tol,
        repack=repack, repack_threshold=repack_threshold,
        adaptive=adaptive, adaptive_ratio=adaptive_ratio)
    # one segment of the carried-state machinery (``build_pipeline``)
    # that ``repro_torch.resilience.solve_segmented`` runs in several
    sharded_passcode_solve.epoch_rounds = []
    sharded_passcode_solve.task_rounds = []
    if not pipeline:
        return _driver_solve(setup, epochs=epochs, alpha0=alpha0, w0=w0,
                             blocks=blocks, use_kernel=use_kernel)
    st = init_pipeline_state(setup, total_epochs=epochs, alpha0=alpha0,
                             w0=w0)
    st = build_pipeline(setup, epochs=epochs, blocks=blocks)(setup.X, st)
    return finalize_state(setup, st, epochs=epochs)


def _driver_solve(setup: SolverSetup, *, epochs: int, alpha0, w0, blocks,
                  use_kernel) -> ShardedResult:
    """The ``pipeline=False`` solve: the setup's epoch function
    (``make_sharded_epoch`` or ``make_sharded_epoch_2d``) under
    ``_drive_epochs``, from the key ``PRNGKey(seed)``."""
    mesh = (solver_mesh_2d(data=setup.p, model=setup.m) if setup.two_d
            else SolverMesh(("data",), (setup.p,)))
    if setup.lay is not None:
        mesh = mesh._replace(device_mesh=setup.lay.device_mesh)
    if setup.two_d:
        epoch_fn = make_sharded_epoch_2d(
            mesh, setup.loss, delay_rounds=setup.delay_rounds,
            use_kernel=use_kernel, overlap=setup.overlap,
            device=setup.device)
    else:
        epoch_fn = make_sharded_epoch(
            mesh, setup.loss, delay_rounds=setup.delay_rounds,
            use_kernel=use_kernel, ell=setup.ell, device=setup.device)
    gap = _make_gap(setup, setup.X)
    alpha, w = _init_alpha_w(setup, alpha0, w0)
    # the epoch functions take every shard's schedule
    draw = (None if blocks is None
            else _block_draw(setup._replace(local=()), blocks, epochs))
    alpha, w, gaps = _drive_epochs(
        epoch_fn, setup.X, setup.sq_norms, alpha[0], w[0],
        torch.zeros_like(w[0]), p=setup.p, n_loc=setup.n_loc, n=setup.n,
        n_blocks=setup.n_blocks, block_size=setup.block_size, epochs=epochs,
        key=prng.PRNGKey(setup.seed, device=setup.device),
        record=setup.record, gap_every=setup.gap_every,
        delay_rounds=setup.delay_rounds,
        gap_fn=lambda a, w_view: gap(a, w_view)[0],
        draw=draw)
    return _finalize(setup, alpha[None], w[None], gaps[None], epochs)


# the host reads of the solver's device state (the repacked round counts
# once an epoch, the segmented solve's health code once a segment), and
# the rounds run per epoch of the last solve, in all and per task
sharded_passcode_solve.host_reads = 0
sharded_passcode_solve.epoch_rounds = []
sharded_passcode_solve.task_rounds = []


def sharded_passcode_feature(X_host, loss, *, mesh=None, epochs: int = 10,
                             seed: int = 0, device=None):
    """The reference's back-compat shim for the old feature-sharded demo:
    ``sharded_passcode_solve`` on a (data = 1, model = m) mesh with one
    block of B = n rows an epoch and no records — one serial pass over a
    permutation of all rows, Algorithm 1's order.  ``mesh`` defaults to
    ``solver_mesh_2d(model=1)`` (the port's shards are virtual; the
    reference takes one a device).  On the card the block's n × n Gram
    takes B4 and B5's layout past 1,024 ids.  Returns ``(alpha, w_hat)``."""
    if mesh is None:
        mesh = solver_mesh_2d(data=1, model=1)
    n = X_host.n_rows if isinstance(X_host, EllMatrix) else X_host.shape[0]
    r = sharded_passcode_solve(X_host, loss, mesh=mesh, epochs=epochs,
                               block_size=n, seed=seed, record=False,
                               device=device)
    return r.alpha, r.w_hat
