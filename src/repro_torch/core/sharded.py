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

Knobs of the reference outside these slices — pods, multi-task labels,
the ``pipeline=False`` host driver — raise ``NotImplementedError``
naming their ROADMAP item.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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
    resolve_device,
    resolve_self_tuning,
    solver_mesh_2d,
)
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


def _data_sum(dw, w):
    """The psum over ``data``: the p shards' Δw (p, *w.shape) summed in
    shard order (a Δw of w's own shape is already one)."""
    if dw.dim() == w.dim():
        return dw
    return dw[0] if dw.shape[0] == 1 else dw.sum(0)


def _block_update_1d(loss, ell: bool, n_loc: int = 0):
    """The round's block engine, the counterpart of the reference's
    ``_local_block_update_ell`` / ``_local_block_update``: the B1 or B2
    wrapper over the (p, B) shard-local ids, returning (updated α, the
    shards' Δw (p, *w.shape)).  ``act`` freezes shrunk rows."""

    def block_update(X_loc, sq_loc, alpha, w_eff, idx_block, act=None):
        if ell:
            cols_loc, vals_loc = X_loc
            return dcd_ell_block_update(cols_loc, vals_loc, sq_loc, alpha,
                                        w_eff, idx_block, loss=loss,
                                        active=act, n_loc=n_loc)
        return dcd_block_update(X_loc, sq_loc, alpha, w_eff, idx_block,
                                loss=loss, active=act, n_loc=n_loc)

    return block_update


def _local_block_update_feature(cols, vals, sq_norms, alpha, w, idx_block,
                                loss, act=None):
    """The unfused 2-D engine (the reference's
    ``_local_block_update_feature``) for one data shard: B sequential
    updates of the row ids ``idx_block``, each summing the m shards'
    O(k_loc) partial dots — the reference's per-update psum over
    ``model`` — and scattering into every shard's own slice.
    ``sq_norms`` are the full row norms, so δ is one value for all
    shards; ``act`` (0/1) freezes shrunk rows.  Returns (updated α, Δw
    over the (m, d_loc + 1) slices)."""
    alpha, w_cur = alpha.clone(), w.clone()
    d1 = w.shape[1]
    w_flat = w_cur.view(-1)
    for i in idx_block.tolist():
        ids = flat_shard_ids(cols[i], d1)  # (m, k)
        v = vals[i]
        wx = torch.sum(torch.sum(w_flat[ids] * v, dim=1))
        delta = loss.delta(alpha[i], wx, sq_norms[i])
        if act is not None:
            delta = torch.where(act[i] > 0.0, delta, 0.0)
        alpha[i] = alpha[i] + delta
        w_flat.index_add_(0, ids.reshape(-1), (delta * v).reshape(-1))
    return alpha, w_cur - w


def _block_update_2d(loss, fused: bool, workspace, n_loc: int = 0):
    """The 2-D block engine over the (p, B) shard-local ids (eager
    composition; the overlapped round drives the split phases directly).
    Returns (updated α, the data shards' Δw (p, m, d_loc + 1))."""

    def block_update(cols, vals, sq_norms, alpha, w_eff, idx_block,
                     act=None):
        if fused:
            return dcd_feature_block_update(cols, vals, sq_norms, alpha,
                                            w_eff, idx_block, loss=loss,
                                            active=act, workspace=workspace,
                                            n_loc=n_loc)
        dws = []
        for s in range(idx_block.shape[0]):
            alpha, dw = _local_block_update_feature(
                cols, vals, sq_norms, alpha,
                w_eff[s] if w_eff.dim() == 3 else w_eff,
                idx_block[s].long() + s * n_loc, loss, act)
            dws.append(dw)
        return alpha, torch.stack(dws)

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
    repacked epoch's draw.  ``act`` is the shard's (n_loc,) bool mask
    (already ANDed with row validity), ``rp`` the repack flag (a bool
    tensor).  ``active_row_remap`` compacts the active rows to the
    front; the draw permutes [0, count) through the same key chain and
    maps back.  Slots past the count cycle the drawn sequence when
    ``rp`` is off (with ``act`` the valid prefix this is the plain draw
    bit for bit) and point at the inactive rows, δ-gated no-ops, when it
    is on (a fully active shard cycles).  Returns (n_blocks, B) int32."""
    m = n_blocks * block_size
    keys = prng.split(sub, p)
    ids, cnt = active_row_remap(act)
    v = torch.clamp(cnt, min=1)  # an all-frozen shard: one gated no-op
    perm = prng.permutation(keys[my], n_loc)
    order = torch.argsort((perm >= v).to(torch.int8), stable=True)
    pos = torch.arange(m, device=perm.device)
    cyc = perm[order][pos % v]
    n_inact = n_loc - cnt
    noop = cnt + pos % torch.clamp(n_inact, min=1)
    fill = torch.where(rp & (n_inact > 0), noop, cyc)
    sel = ids[torch.where(pos < v, cyc, fill)]
    return sel.reshape(n_blocks, block_size).to(torch.int32)


def _scan_rounds(block_update, alpha_loc, w_loc, dw_prev, blocks_loc,
                 delay_rounds: int):
    """The round structure: per round the block engine runs against the
    (possibly stale) effective w, and its Δw — summed over the ``data``
    shards — is applied now (atomic) or one round late
    (``delay_rounds``), the reference's exact bookkeeping.
    ``block_update(alpha, w_eff, idx_block)`` closes over the shards."""
    for idx_block in blocks_loc:
        w_eff = w_loc + dw_prev if delay_rounds > 0 else w_loc
        alpha_loc, dw_loc = block_update(alpha_loc, w_eff, idx_block)
        dw_all = _data_sum(dw_loc, w_loc)
        if delay_rounds > 0:
            w_loc, dw_prev = w_loc + dw_prev, dw_all
        else:
            w_loc = w_loc + dw_all
    return alpha_loc, w_loc, dw_prev


def _scan_rounds_dyn(block_update, alpha, w, dw_prev, dw_own, blocks, act,
                     n_run: int, delay_flag):
    """The self-tuning round scan (the reference's ``_scan_rounds_dyn``):
    ``_scan_rounds`` with (a) the active mask ``act`` gating every δ,
    (b) only the first ``n_run`` rounds run (the repacked block count),
    and (c) the delayed mode a runtime flag with real stale reads:
    while ``delay_flag`` is set a round's Δw sum stays in flight for one
    round and the next round reads w with its own shard's last-round
    updates (``dw_own``, (p, *w.shape)) but not its peers', τ ≈
    2·B·(p−1).  ``delay_flag`` is a host int (fixed) or a device int32
    tensor (the adaptive latch, read without a sync).  Returns (α, w,
    Δw in flight, dw_own)."""
    fixed = not torch.is_tensor(delay_flag)
    on = delay_flag > 0
    for idx_block in blocks[:n_run]:
        if fixed:  # never delayed: dw_prev stays 0, w_eff is w
            w_eff = w + dw_own if on else w
        else:
            w_eff = w + torch.where(on, dw_own, dw_prev)
        alpha, dw_loc = block_update(alpha, w_eff, idx_block, act)
        dw_all = _data_sum(dw_loc, w)
        if fixed and on:
            w, dw_prev, dw_own = w + dw_prev, dw_all, dw_loc
        elif fixed:  # never delayed: nothing is in flight
            w = w + dw_all
        else:
            w = w + dw_prev + torch.where(on, 0.0, dw_all)
            dw_prev = torch.where(on, dw_all, 0.0)
            dw_own = torch.where(on, dw_loc, 0.0)
    return alpha, w, dw_prev, dw_own


def _overlap_round_fns(cols, vals, sq_norms, loss, n_loc: int = 0):
    """The three split phases of the fused 2-D block round, bound to the
    resident slices (``repro_torch.kernels.ops`` entry points), over the
    (p, B) shard-local ids.  B4 (``gram_fn``) fills the workspace it is
    given with the block's buckets, which B5 (``update_fn``) of the same
    block reads."""

    def gram_fn(w_ref, idx, workspace):
        return dcd_feature_gram(cols, vals, w_ref, idx, workspace=workspace,
                                n_loc=n_loc)

    def corr_fn(dvec, idx):
        return dcd_feature_base_correction(cols, vals, dvec, idx,
                                           n_loc=n_loc)

    def update_fn(alpha, w_ref, idx, base, gram, workspace, act=None):
        return dcd_feature_update(cols, vals, sq_norms, alpha, w_ref, idx,
                                  base, gram, loss=loss, active=act,
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
        w, dw_prev, inflight = (w_next, _data_sum(w_upd - w_next, w_next),
                                inflight_next)
    return alpha, w, dw_prev, inflight


def _gap_slots(epochs: int, gap_every: int) -> int:
    """How many duality gaps the solve records — every ``gap_every``-th
    epoch plus the final one."""
    gap_every = max(int(gap_every), 1)
    return sum(1 for e in range(epochs)
               if (e + 1) % gap_every == 0 or e == epochs - 1)


def _make_gap_1d(loss, X_loc, ell: bool, d_run: int):
    """The duality gap and the backward-error metric over the rows of
    ``X_loc`` (the real rows: the padding is the layout's tail, so the
    caller hands the first n rows and α[:n]): gap(α) = ‖w(α)‖² + Σ_i
    [ℓ(w(α)ᵀx_i) + ℓ*(−α_i)] and ‖w(α) − ŵ‖ against the maintained
    primal view ``w_view`` (ε = w̄ − ŵ of ``core/backward_error.py``).
    Returns device scalars: no host sync."""
    if ell:
        cols_loc, vals_loc = X_loc

        def rmv(a):
            wa = torch.zeros((d_run,), dtype=torch.float32,
                             device=a.device)
            return wa.index_add_(0, cols_loc.reshape(-1).long(),
                                 (a[:, None] * vals_loc).reshape(-1))

        def mv(wa):
            return torch.sum(wa[cols_loc.long()] * vals_loc, dim=1)
    else:
        def rmv(a):
            return X_loc.T @ a

        def mv(wa):
            return X_loc @ wa

    def gap(alpha_loc, w_view):
        wa = rmv(alpha_loc)
        s = torch.sum(loss.primal_loss(mv(wa)) + loss.conj(alpha_loc))
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


def _make_gap_2d(loss, cols, vals, chunk_elems: int = 1 << 26):
    """``_make_gap_1d`` for the feature shards: w(α) stays one slice per
    shard, each row's dot and ‖w(α)‖² are sums of the shards' partials
    (the reference's psums over ``model``).  Works in row chunks of about
    ``chunk_elems`` entries, so no (n, m, k_loc) temporary is formed,
    and scatters only real entries (padding lanes would all add 0 into
    the m dummy slots)."""
    m = cols.shape[1]
    rows = _chunk_rows(cols, chunk_elems)

    def gap(alpha, w_view):
        d1 = w_view.shape[1]
        wa = torch.zeros((m * d1,), dtype=torch.float32, device=alpha.device)
        for c, v, a in zip(cols.split(rows), vals.split(rows),
                           alpha.split(rows)):
            real = c < d1 - 1
            wa.index_add_(0, flat_shard_ids(c, d1)[real],
                          (a[:, None, None] * v)[real])
        wa = wa.view(m, d1)
        z = _row_dots_2d(cols, vals, wa, rows)
        s = torch.sum(loss.primal_loss(z) + loss.conj(alpha))
        e = wa - w_view  # the dummy slots are 0 in both
        return (torch.sum(torch.sum(wa * wa, dim=1)) + s,
                torch.sqrt(torch.sum(torch.sum(e * e, dim=1))))

    return gap


def _make_shrink(setup, chunk_elems: int = 1 << 26):
    """The active-mask recompute (the reference's ``_make_shrink_1d`` /
    ``_2d``): fresh projected gradients from (α, w_view) — wᵀx_i by the
    layout's own matvec (on the 2-D mesh the sum of the shards' partial
    dots, in row chunks) — through ``active_mask_from_w``, ANDed with
    row validity so padding rows never count as active.  Returns an
    (n_pad,) bool mask."""
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
        return active_mask_from_w(setup.loss, alpha, mv(w_view),
                                  setup.shrink_tol) & valid

    return mask_fn, valid


class SolverSetup(NamedTuple):
    """The resolved and placed half of a solve: knobs, sizes and the
    device-resident, row-padded dataset (n_pad = p·n_loc rows, shard s
    the rows [s·n_loc, (s+1)·n_loc), the padding the tail)."""

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

    @property
    def n_pad(self) -> int:
        return self.p * self.n_loc


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
    every keyword of the reference's; ``y`` (the reference's (K, n)
    multi-task labels), pods and ``pipeline=False`` raise
    ``NotImplementedError`` (``_reject_unported``), and the self-tuning
    knobs are validated by ``resolve_self_tuning``."""
    mesh = _resolve_mesh(mesh, mesh_axes)
    _reject_unported(mesh=mesh, pod_delay_rounds=pod_delay_rounds,
                     multitask=y is not None, pipeline=pipeline)
    dev = resolve_device(device)
    _check_use_kernel(use_kernel, dev)
    if int(block_size) < 1:
        raise ValueError(f"block_size must be ≥ 1, got {block_size}")
    if int(delay_rounds) < 0:
        raise ValueError(f"delay_rounds must be ≥ 0, got {delay_rounds}")
    two_d = "model" in mesh.axis_names
    p = dp_size(mesh)
    ell = isinstance(X_host, EllMatrix)
    fused = two_d and _fused_2d(use_kernel, dev)
    overlap_on = pipeline_overlap(overlap, two_d=two_d, fused=fused,
                                  delay_rounds=int(delay_rounds))
    tuning = resolve_self_tuning(shrink_every, repack, adaptive,
                                 overlap_knob=overlap, overlap_on=overlap_on,
                                 pipeline=pipeline, record=record)
    if two_d:
        ell_m = X_host.to(dev) if ell else dense_to_ell(X_host, device=dev)
        n, d = ell_m.n_rows, ell_m.n_features
        m = mesh.shape["model"]
        fse = ell_column_split(
            EllMatrix(ell_m.indices.to(torch.int32),
                      ell_m.values.to(torch.float32), d), m)
        n_loc = -(-n // p)
        X = (_pad_rows(fse.indices, p * n_loc, fse.d_loc),
             _pad_rows(fse.values, p * n_loc, 0.0))
        sq_norms = _pad_rows(fse.row_sq_norms(), p * n_loc, 1.0)
        w_shape, extra = (m, fse.d_loc + 1), dict(m=m, d_loc=fse.d_loc)
    elif ell:
        n, d = X_host.n_rows, X_host.n_features
        n_loc = -(-n // p)
        cols = X_host.indices.to(dev, torch.int32).contiguous()
        vals = X_host.values.to(dev, torch.float32).contiguous()
        sq_norms = _pad_rows(torch.sum(vals * vals, dim=1), p * n_loc, 1.0)
        X = (_pad_rows(cols, p * n_loc, d), _pad_rows(vals, p * n_loc, 0.0))
        w_shape, extra = (d + 1,), {}
    else:
        X = torch.as_tensor(X_host, dtype=torch.float32,
                            device=dev).contiguous()
        n, d = X.shape
        n_loc = -(-n // p)
        sq_norms = _pad_rows(torch.sum(X * X, dim=1), p * n_loc, 1.0)
        X = _pad_rows(X, p * n_loc, 0.0)
        w_shape, extra = (d,), {}
    if n < 1:
        raise ValueError("X has no rows")
    if ell or two_d:
        cols = X[0]
        lim = extra.get("d_loc", d)
        if not (0 <= int(cols.min()) and int(cols.max()) <= lim):
            raise ValueError(f"ELL column ids must lie in [0, {lim}]")
    return SolverSetup(
        loss=loss, n=n, d=d, n_loc=n_loc,
        n_blocks=_n_blocks(n_loc, block_size),
        block_size=int(block_size), w_shape=w_shape, ell=ell or two_d, X=X,
        sq_norms=sq_norms, delay_rounds=int(delay_rounds),
        gap_every=max(int(gap_every), 1), record=record, seed=int(seed),
        device=dev, two_d=two_d, fused=fused, overlap=tuning.overlap, p=p,
        tuning=tuning, shrink_tol=float(shrink_tol),
        repack_threshold=float(repack_threshold),
        adaptive_ratio=float(adaptive_ratio), **extra)


def _init_alpha_w(setup: SolverSetup, alpha0=None, w0=None):
    """(α (n_pad,), w) for a solve — zeros, or a warm start from carried
    state.  A carried ``alpha0``/``w0`` *shorter* than n/d is the
    streaming-append warm start: old coordinates keep their values, new
    ones start at 0.  On a 2-D mesh a (d,) ``w0`` is re-blocked onto the
    shards' slices."""
    dev = setup.device
    alpha = torch.zeros((setup.n_pad,), dtype=torch.float32, device=dev)
    if alpha0 is not None:
        a0 = torch.as_tensor(alpha0, dtype=torch.float32,
                             device=dev).reshape(-1)[:setup.n]
        alpha[: a0.shape[0]] = a0
    w = torch.zeros(setup.w_shape, dtype=torch.float32, device=dev)
    if w0 is not None:
        v0 = torch.as_tensor(w0, dtype=torch.float32,
                             device=dev).reshape(-1)[:setup.d]
        if setup.two_d:
            flat = torch.zeros((setup.m * setup.d_loc,), dtype=torch.float32,
                               device=dev)
            flat[: v0.shape[0]] = v0
            w[:, :setup.d_loc] = flat.view(setup.m, setup.d_loc)
        else:
            w[: v0.shape[0]] = v0
    return alpha, w


def _finalize(setup: SolverSetup, alpha, w, gaps, epochs, eps=None,
              active=None, delay=None):
    """Back to user coordinates: drop the padding rows and the dummy
    slot, and on a 2-D mesh stitch ŵ out of the shards' slices."""
    if setup.two_d:
        w = w[:, :setup.d_loc].reshape(-1)
    return ShardedResult(alpha[:setup.n], w[:setup.d], gaps, epochs, eps,
                         active, delay)


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


def _reject_unported(*, mesh, pod_delay_rounds, multitask, pipeline):
    """The reference's knobs outside the ported slices: each raises,
    naming the ROADMAP item that ports it; none is silently ignored."""
    axes = tuple(mesh.axis_names)
    if multitask:
        raise NotImplementedError(
            "a (K, n) multi-task label matrix is ROADMAP A.9 (multi-task), "
            "not yet ported")
    if "pod" in axes or pod_delay_rounds:
        raise NotImplementedError(
            "pods (a 'pod' mesh axis, pod_delay_rounds) are ROADMAP A.10, "
            "not yet ported")
    if "task" in axes:
        raise NotImplementedError(
            "a 'task' mesh axis is ROADMAP A.9 (multi-task), not yet ported")
    if axes not in (("data",), ("data", "model")):
        raise ValueError(f"mesh axes {axes}: the solver runs on ('data',) "
                         "or ('data', 'model')")
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


def _block_schedule(setup: SolverSetup, blocks, epochs: int):
    """``draw(e, act=None, rp=None)``: epoch e's (n_blocks, p, B)
    shard-local ids, round-major — from ``blocks`` (an epoch past the
    schedule repeats its last one: only the overlapped round's peek past
    the final epoch asks, and discards it) or through the reference's
    key chain, ``PRNGKey(seed)`` then per epoch ``key, sub =
    split(key)``.  With an active mask ``act`` (n_pad,) and repack flag
    ``rp`` the draw is the masked one (``_device_block_perm_masked``)."""
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

    def draw(e, act=None, rp=None):
        if act is None:
            per = [_device_block_perm(subs[e], my, p, n_loc, setup.n, nb, B)
                   for my in range(p)]
        else:
            acts = act.view(p, n_loc)
            per = [_device_block_perm_masked(subs[e], my, p, n_loc, nb, B,
                                             acts[my], rp)
                   for my in range(p)]
        return torch.stack(per, dim=1)  # (n_blocks, p, B)

    return draw


def _workspaces(setup: SolverSetup):
    """B4's workspaces on the card: one for the eager round, two that
    alternate for the overlapped one (B4 of block t + 1 runs before B5
    of block t, which reads block t's buckets); None on the CPU."""
    if not (setup.fused and setup.device.type == "cuda"):
        return (None, None)
    return tuple(
        gram_workspace(setup.m, setup.block_size, setup.X[0].shape[2],
                       setup.w_shape[1], setup.device, setup.p)
        for _ in range(2 if setup.overlap else 1))


def _epoch_scan(setup: SolverSetup, engine, gap, draw, alpha, w, *,
                epochs: int, overlap_fns=None, workspaces=None):
    """The epoch loop (the reference's ``_epoch_scan`` without pods,
    the watchdog and the fault triple): draw each epoch's blocks, run
    its rounds — the static ``_scan_rounds``, the self-tuning
    ``_scan_rounds_dyn`` or the overlapped ``_scan_rounds_overlap``
    (whose in-flight aggregate crosses epochs) — and record the gap,
    ‖w(α) − ŵ‖, the active fraction and the delay flag into
    preallocated device buffers.  Shrinking recomputes the mask every
    ``shrink_every`` epochs (the final epoch runs unshrunk); repacking
    draws an epoch over the compacted active set when the fraction
    summed over the shards is below the threshold, and runs as many
    rounds as the largest shard's count needs — read on the host once an
    epoch, the solve's only sync (counted in
    ``sharded_passcode_solve.host_reads``; the epochs' round counts are
    kept in ``sharded_passcode_solve.epoch_rounds``); the adaptive delay
    lowers its device flag at records (one-way), and with shrinking a
    hard stall turns repacking off for good.  Returns (α, w, Δw in flight, gaps,
    eps, active, delay)."""
    st, dev = setup.tuning, w.device
    sharded_passcode_solve.epoch_rounds = []
    n_gaps = _gap_slots(epochs, setup.gap_every) if setup.record else 0
    gaps, epsb, actb, delayb = (torch.zeros((n_gaps,), dtype=torch.float32,
                                            device=dev) for _ in range(4))
    shrink_on, adaptive = st.shrink_every > 0, st.adaptive
    dyn = (shrink_on or adaptive) and not setup.overlap
    dw = torch.zeros_like(w)
    dwo = torch.zeros((setup.p, *w.shape), dtype=torch.float32,
                      device=dev) if dyn else None
    if shrink_on:
        mask_fn, valid = _make_shrink(setup)
        act, frac = valid, torch.ones((), device=dev)
        nrun = torch.tensor(setup.n_blocks, device=dev)
        rp = torch.zeros((), dtype=torch.bool, device=dev)
    if adaptive:
        delay = torch.tensor(setup.delay_rounds, dtype=torch.int32,
                             device=dev)
        gapprev = torch.tensor(float("inf"), device=dev)
        rpok = torch.ones((), dtype=torch.int32, device=dev)
    inflight = None
    if setup.overlap:
        first = draw(0, valid, rp) if shrink_on else draw(0)
        inflight = (*overlap_fns[0](w, first[0], workspaces[0]),
                    workspaces[0])
    slot = 0
    for e in range(epochs):
        final = e == epochs - 1
        n_run, act_run = setup.n_blocks, None
        if shrink_on:
            if e % st.shrink_every == 0:
                act = mask_fn(alpha, w + dw)
                cnt = act.view(setup.p, setup.n_loc).sum(1)
                frac = cnt.sum().float() / setup.n
                if st.repack:
                    rp = frac < setup.repack_threshold
                    nrun = torch.clamp(-(-cnt.max() // setup.block_size), 1,
                                       setup.n_blocks)
            act_run = (valid if final else act).float()
            use_rp = rp & (not final)
            if adaptive:
                use_rp = use_rp & (rpok > 0)
            blocks = draw(e, torch.where(use_rp, act, valid), use_rp)
            if st.repack:
                # the epoch's round count, read on the host: one sync an
                # epoch, and none a round
                n_run = int(torch.where(use_rp, nrun, setup.n_blocks))
                sharded_passcode_solve.host_reads += 1
        else:
            blocks = draw(e)
        sharded_passcode_solve.epoch_rounds.append(n_run)
        delay_flag = delay if adaptive else setup.delay_rounds
        if setup.overlap:
            nxt = (draw(e + 1, valid, torch.zeros_like(rp)) if shrink_on
                   else draw(e + 1))[0]
            alpha, w, dw, inflight = _scan_rounds_overlap(
                *overlap_fns, alpha, w, dw, blocks, inflight, nxt,
                workspaces, act_run)
        elif dyn:
            alpha, w, dw, dwo = _scan_rounds_dyn(
                engine, alpha, w, dw, dwo, blocks, act_run, n_run,
                delay_flag)
        else:
            alpha, w, dw = _scan_rounds(engine, alpha, w, dw, blocks,
                                        setup.delay_rounds)
        if setup.record and ((e + 1) % setup.gap_every == 0 or final):
            g, eps = gap(alpha[:setup.n], w + dw)
            gaps[slot], epsb[slot] = g, eps
            actb[slot] = frac if shrink_on else 1.0
            delayb[slot] = delay_flag
            if adaptive:
                # the gap-trend controller, through a one-way latch
                new_flag = adaptive_delay_policy(
                    gapprev, g, improve_ratio=setup.adaptive_ratio)
                delay = torch.minimum(delay_flag, new_flag)
                if shrink_on:
                    # the sticky repack guard keys on a hard stall
                    rpok = rpok * adaptive_delay_policy(gapprev, g)
                gapprev = g
            slot += 1
    return alpha, w, dw, gaps, epsb, actb, delayb


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
    into X at the mouth.  The blocks are drawn through the reference's
    key chain from ``seed``; ``blocks`` replaces the draw with an
    explicit schedule ((epochs, n_blocks, B) row ids at p = 1,
    (epochs, p, n_blocks, B) shard-local ids at p > 1).  Pods, a (K, n)
    multi-task ``y`` and ``pipeline=False`` raise ``NotImplementedError``
    naming their ROADMAP item (``prepare_solver``).
    """
    dev = resolve_device(device)
    # a (K, n) label matrix is the multi-task solve: not folded into X
    multitask = y is not None and len(getattr(y, "shape", ())) == 2
    X_host = X_host.to(dev) if isinstance(X_host, EllMatrix) else \
        torch.as_tensor(X_host, dtype=torch.float32, device=dev)
    X_host = _validate_solver_inputs(X_host, None if multitask else y, loss)
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
    n = setup.n
    overlap_fns = workspaces = None
    if setup.two_d:
        cols, vals = setup.X
        workspaces = _workspaces(setup)
        engine = functools.partial(
            _block_update_2d(setup.loss, setup.fused, workspaces[0],
                             setup.n_loc), cols, vals, setup.sq_norms)
        if setup.overlap:
            overlap_fns = _overlap_round_fns(cols, vals, setup.sq_norms,
                                             setup.loss, setup.n_loc)
        gap = _make_gap_2d(setup.loss, cols[:n], vals[:n])
    else:
        engine = functools.partial(
            _block_update_1d(setup.loss, setup.ell, setup.n_loc), setup.X,
            setup.sq_norms)
        X_real = ((setup.X[0][:n], setup.X[1][:n]) if setup.ell
                  else setup.X[:n])
        gap = _make_gap_1d(setup.loss, X_real, setup.ell, setup.w_shape[0])
    alpha, w, dw, gaps, eps, active, delay = _epoch_scan(
        setup, engine, gap, draw, alpha, w, epochs=epochs,
        overlap_fns=overlap_fns, workspaces=workspaces)
    st = setup.tuning
    if setup.delay_rounds > 0 or st.shrink_every or st.adaptive:
        w = w + dw  # flush the in-flight aggregate (0 when synchronous)
    return _finalize(setup, alpha, w, gaps, epochs, eps, active, delay)


sharded_passcode_solve.host_reads = 0
sharded_passcode_solve.epoch_rounds = []


def sharded_passcode_feature(X_host, loss, *, mesh=None, epochs: int = 10,
                             seed: int = 0):
    """The reference's back-compat shim (one n-row block per epoch on the
    2-D mesh).  Not ported: its B = n would need an n × n Gram."""
    raise NotImplementedError(
        "sharded_passcode_feature (one block of B = n rows, an n × n Gram) "
        "is ROADMAP A′.12, not yet ported; call sharded_passcode_solve "
        "with mesh=solver_mesh_2d(model=m)")
