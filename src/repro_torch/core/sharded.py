"""PASSCoDe-Atomic on one GPU — the pipelined solver of
``repro/core/sharded.py`` at p = 1 ``data`` shard, on the 1-D
``("data",)`` mesh and on the 2-D ``("data", "model")`` mesh.

The reference shards rows over p devices; each device runs a *block* of
B locally-sequential DCD updates against its view of w, then the
per-device Δw are psummed (atomic semantics, staleness τ ≤ B·(p−1)), or
folded in one round late with ``delay_rounds ≥ 1``.  The port runs one
shard, p = 1, which is what the reference runs on one chip: the psum is
the identity and the solve is serial DCD in the block-draw order.  The
round structure is kept exactly — one block-engine call per round,
returning (α, Δw = w_new − w), then w += Δw — because the Δw round trip
rounds differently from carrying w, and parity with the reference
relies on doing the same.

**1-D mesh.**  w is one (d+1,) padded primal (ELL, dummy slot at d) or
(d,) vector (dense).  Per round the block engine is the B1 wrapper
(``repro_torch.kernels.ops.dcd_ell_block_update``) on an ``EllMatrix``,
or the B2 wrapper (``dcd_block_update``) on a dense X.  Each launches
its CUDA kernel for tensors on the card and runs the kernel's plain
version for tensors on the CPU.

**2-D mesh** (``mesh=solver_mesh_2d(model=m)``, the webspam/kddb regime
of the reference's DESIGN.md §10).  The reference's ``model`` axis
becomes m virtual feature shards on the one card: X is split into a
``FeatureShardedEll`` ((n, m, k_loc) shard-local slices) and w is an
(m, d_loc + 1) tensor, one primal slice per row with its dummy slot at
local index d_loc; the psum over ``model`` becomes a sum over the shard
dimension.  This is the reference's legacy ``("model",)`` mesh mapped
to (data = 1, model = m): within each round the updates are serial in i
and the features are sharded.  Two engines, resolved as the reference's
``_resolve_kernel_mode_feature`` ("auto" fuses only on the card):

  use_kernel   on cuda                        on cpu
  "auto"       fused (B4 → sum → B5 kernels)  unfused
  True         fused (kernels)                fused (B4/B5 plain versions)
  False        raises                         unfused

The unfused engine (``_local_block_update_feature``) sums the shards'
partial dots per update; the fused engine batches a block's B sums into
one (base, Gram) sum between B4 and B5.  With ``delay_rounds ≥ 1`` the
fused engine double-buffers the round (``overlap``, resolved by
``repro_torch.dist.mesh.pipeline_overlap``): the (base, Gram) of block
t + 1 is formed while block t's is consumed, its stale base repaired by
``dcd_feature_base_correction``, and the aggregate in flight is carried
across epochs — each epoch peeks the next epoch's first block through
the key chain.

**The draw.**  Each epoch draws its blocks (``_device_block_perm``)
through the reference's ``jax.random`` key chain, bit-exact
(``repro_torch.prng``): ``key = PRNGKey(seed)``, per epoch ``key, sub =
split(key)``, then ``split(sub, p)`` and ``permutation`` of the
shard's rows — so a seed gives the reference's updates.  ``blocks=``
replaces the draw with an explicit (epochs, n_blocks, B) schedule.
Duality gaps and the backward-error metric ‖w(α) − ŵ‖ are recorded into
preallocated device buffers every ``gap_every`` epochs (and at the
last), so nothing syncs with the host until the solve returns.

Knobs of the reference outside these slices — p > 1 ``data`` shards,
shrinking, repacking, the adaptive delay, pods, multi-task labels, the
``pipeline=False`` host driver — raise ``NotImplementedError`` naming
their ROADMAP item.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch import prng
from repro_torch.data.sparse import (
    EllMatrix,
    dense_to_ell,
    ell_column_split,
    flat_shard_ids,
)
from repro_torch.dist.mesh import (
    SolverMesh,
    pipeline_overlap,
    resolve_device,
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
    active: torch.Tensor | None = None  # active-set fraction (always 1)
    delay: torch.Tensor | None = None  # effective delay flag


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


def _block_update_1d(loss, ell: bool):
    """The shard's block engine, the counterpart of the reference's
    ``_local_block_update_ell`` / ``_local_block_update``: the B1 or B2
    wrapper, returning (updated α shard, local Δw)."""

    def block_update(X_loc, sq_loc, alpha_loc, w_eff, idx_block):
        if ell:
            cols_loc, vals_loc = X_loc
            return dcd_ell_block_update(cols_loc, vals_loc, sq_loc,
                                        alpha_loc, w_eff, idx_block,
                                        loss=loss)
        return dcd_block_update(X_loc, sq_loc, alpha_loc, w_eff, idx_block,
                                loss=loss)

    return block_update


def _local_block_update_feature(cols, vals, sq_norms, alpha, w, idx_block,
                                loss):
    """The unfused 2-D engine (the reference's
    ``_local_block_update_feature``): B sequential updates, each summing
    the m shards' O(k_loc) partial dots — the reference's per-update
    psum over ``model`` — and scattering into every shard's own slice.
    ``sq_norms`` are the full row norms, so δ is one value for all
    shards.  Returns (updated α, Δw over the (m, d_loc + 1) slices)."""
    alpha, w_cur = alpha.clone(), w.clone()
    d1 = w.shape[1]
    w_flat = w_cur.view(-1)
    for i in idx_block.tolist():
        ids = flat_shard_ids(cols[i], d1)  # (m, k)
        v = vals[i]
        wx = torch.sum(torch.sum(w_flat[ids] * v, dim=1))
        delta = loss.delta(alpha[i], wx, sq_norms[i])
        alpha[i] = alpha[i] + delta
        w_flat.index_add_(0, ids.reshape(-1), (delta * v).reshape(-1))
    return alpha, w_cur - w


def _block_update_2d(loss, fused: bool, workspace):
    """The 2-D block engine (eager composition; the overlapped round
    drives the split phases directly)."""

    def block_update(cols, vals, sq_norms, alpha, w_eff, idx_block):
        if fused:
            return dcd_feature_block_update(cols, vals, sq_norms, alpha,
                                            w_eff, idx_block, loss=loss,
                                            workspace=workspace)
        return _local_block_update_feature(cols, vals, sq_norms, alpha,
                                           w_eff, idx_block, loss)

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
    n_loc) are real."""
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


def _scan_rounds(block_update, alpha_loc, w_loc, dw_prev, blocks_loc,
                 delay_rounds: int):
    """The round structure: per round the block engine runs against the
    (possibly stale) effective w, and its Δw — summed over the ``data``
    shards, the identity at p = 1 — is applied now (atomic) or one round
    late (``delay_rounds``).  ``block_update(alpha, w_eff, idx_block)``
    closes over the shard."""
    for idx_block in blocks_loc:
        w_eff = w_loc + dw_prev if delay_rounds > 0 else w_loc
        alpha_loc, dw_all = block_update(alpha_loc, w_eff, idx_block)
        if delay_rounds > 0:
            w_loc, dw_prev = w_loc + dw_prev, dw_all
        else:
            w_loc = w_loc + dw_all
    return alpha_loc, w_loc, dw_prev


def _overlap_round_fns(cols, vals, sq_norms, loss):
    """The three split phases of the fused 2-D block round, bound to the
    resident slices (``repro_torch.kernels.ops`` entry points).  B4
    (``gram_fn``) fills the workspace it is given with the block's
    buckets, which B5 (``update_fn``) of the same block reads."""

    def gram_fn(w_ref, idx, workspace):
        return dcd_feature_gram(cols, vals, w_ref, idx, workspace=workspace)

    def corr_fn(dvec, idx):
        return dcd_feature_base_correction(cols, vals, dvec, idx)

    def update_fn(alpha, w_ref, idx, base, gram, workspace):
        return dcd_feature_update(cols, vals, sq_norms, alpha, w_ref, idx,
                                  base, gram, loss=loss, workspace=workspace)

    return gram_fn, corr_fn, update_fn


def _scan_rounds_overlap(gram_fn, corr_fn, update_fn, alpha, w, dw_prev,
                         blocks, inflight, next0, workspaces):
    """``_scan_rounds`` for the fused 2-D engine with the round
    double-buffered: entering round t the carry holds block t's summed
    (base⁰_t, gram_t), whose base was taken against W_t, the primal
    without the round's in-flight aggregate D_t (round t−1's Δw), and
    the workspace B4 filled for block t.  The Gram never depends on w
    and the base is repaired exactly, base_t = base⁰_t + D_tᵀx, while
    block t+1's (base, Gram) is formed against the already known
    W_{t+1} = W_t + D_t — into the other of the two ``workspaces``, so
    B5 of block t still reads block t's buckets.  The bookkeeping is the
    delayed branch of ``_scan_rounds`` (``delay_rounds ≥ 1``; the caller
    flushes the last aggregate).  ``inflight`` is blocks[0]'s (base⁰,
    Gram, workspace) against the entering w, ``next0`` the first block
    of the following epoch; returns (α, w, Δw, the aggregate issued for
    ``next0``)."""
    nxt = list(blocks[1:]) + [next0]
    for idx, idx_next in zip(blocks, nxt):
        base0, gram, ws = inflight
        ws_next = workspaces[1] if ws is workspaces[0] else workspaces[0]
        w_next = w + dw_prev  # W_{t+1}: known before D_{t+1} lands
        inflight_next = (*gram_fn(w_next, idx_next, ws_next), ws_next)
        base = base0 + corr_fn(dw_prev, idx)
        alpha, w_upd = update_fn(alpha, w_next, idx, base, gram, ws)
        w, dw_prev, inflight = w_next, w_upd - w_next, inflight_next
    return alpha, w, dw_prev, inflight


def _gap_slots(epochs: int, gap_every: int) -> int:
    """How many duality gaps the solve records — every ``gap_every``-th
    epoch plus the final one."""
    gap_every = max(int(gap_every), 1)
    return sum(1 for e in range(epochs)
               if (e + 1) % gap_every == 0 or e == epochs - 1)


def _make_gap_1d(loss, X_loc, ell: bool, d_run: int):
    """The duality gap of the shard and the backward-error metric:
    gap(α) = ‖w(α)‖² + Σ_i [ℓ(w(α)ᵀx_i) + ℓ*(−α_i)] and ‖w(α) − ŵ‖
    against the maintained primal view ``w_view`` (ε = w̄ − ŵ of
    ``core/backward_error.py``).  At p = 1 every row is real, so no row
    mask is needed.  Returns device scalars: no host sync."""
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


def _make_gap_2d(loss, cols, vals, chunk_elems: int = 1 << 26):
    """``_make_gap_1d`` for the feature shards: w(α) stays one slice per
    shard, each row's dot and ‖w(α)‖² are sums of the shards' partials
    (the reference's psums over ``model``).  Works in row chunks of about
    ``chunk_elems`` entries, so no (n, m, k_loc) temporary is formed,
    and scatters only real entries (padding lanes would all add 0 into
    the m dummy slots)."""
    n, m, k = cols.shape
    rows = max(1, chunk_elems // (m * k))

    def gap(alpha, w_view):
        d1 = w_view.shape[1]
        wa = torch.zeros((m * d1,), dtype=torch.float32, device=alpha.device)
        for c, v, a in zip(cols.split(rows), vals.split(rows),
                           alpha.split(rows)):
            real = c < d1 - 1
            wa.index_add_(0, flat_shard_ids(c, d1)[real],
                          (a[:, None, None] * v)[real])
        z = torch.cat([
            torch.sum(torch.sum(wa[flat_shard_ids(c, d1)] * v, dim=2), dim=1)
            for c, v in zip(cols.split(rows), vals.split(rows))])
        wa = wa.view(m, d1)
        s = torch.sum(loss.primal_loss(z) + loss.conj(alpha))
        e = wa - w_view  # the dummy slots are 0 in both
        return (torch.sum(torch.sum(wa * wa, dim=1)) + s,
                torch.sqrt(torch.sum(torch.sum(e * e, dim=1))))

    return gap


def _epoch_scan(rounds, gap, alpha, w, dw, *, epochs: int, gap_every: int,
                record: bool):
    """The static epoch loop: run epoch e's rounds (``rounds(e, α, w,
    Δw)`` draws its own blocks) and record the gap and ‖w(α) − ŵ‖ into
    preallocated device buffers.  Returns (α, w, dw, gaps, eps)."""
    n_gaps = _gap_slots(epochs, gap_every) if record else 0
    gaps = torch.zeros((n_gaps,), dtype=torch.float32, device=w.device)
    epsb = torch.zeros((n_gaps,), dtype=torch.float32, device=w.device)
    slot = 0
    for e in range(epochs):
        alpha, w, dw = rounds(e, alpha, w, dw)
        if record and ((e + 1) % gap_every == 0 or e == epochs - 1):
            gaps[slot], epsb[slot] = gap(alpha, w + dw)
            slot += 1
    return alpha, w, dw, gaps, epsb


class SolverSetup(NamedTuple):
    """The resolved and placed half of a solve: knobs, sizes and the
    device-resident dataset."""

    loss: object
    n: int
    d: int
    n_loc: int
    n_blocks: int
    block_size: int
    w_shape: tuple  # (d+1,) ELL / (d,) dense on 1-D; (m, d_loc+1) on 2-D
    ell: bool
    X: object  # (cols, vals) — (n, k) or (n, m, k_loc) — or dense (n, d)
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
    device — the reference's ``prepare_solver`` at p = 1, without lane
    padding and, at p = 1, without row padding.  On a 2-D mesh a dense X
    converts to ELL and is split into ``FeatureShardedEll`` slices on
    the device.  It takes every keyword of the reference's; ``y`` (the
    reference's (K, n) multi-task labels) and the knobs outside the
    ported slices raise ``NotImplementedError`` where a value would act
    (``_reject_unported``).  ``shrink_tol``, ``repack_threshold`` and
    ``adaptive_ratio`` act only with shrinking, repacking or the
    adaptive delay, which raise, so they are accepted as they are."""
    mesh = _resolve_mesh(mesh, mesh_axes)
    _reject_unported(mesh=mesh, pod_delay_rounds=pod_delay_rounds,
                     shrink_every=shrink_every, repack=repack,
                     adaptive=adaptive, multitask=y is not None,
                     pipeline=pipeline)
    dev = resolve_device(device)
    _check_use_kernel(use_kernel, dev)
    if int(block_size) < 1:
        raise ValueError(f"block_size must be ≥ 1, got {block_size}")
    if int(delay_rounds) < 0:
        raise ValueError(f"delay_rounds must be ≥ 0, got {delay_rounds}")
    two_d = "model" in mesh.axis_names
    ell = isinstance(X_host, EllMatrix)
    fused = two_d and _fused_2d(use_kernel, dev)
    overlap_on = pipeline_overlap(overlap, two_d=two_d, fused=fused,
                                  delay_rounds=int(delay_rounds))
    if two_d:
        ell_m = X_host.to(dev) if ell else dense_to_ell(X_host, device=dev)
        n, d = ell_m.n_rows, ell_m.n_features
        m = mesh.shape["model"]
        fse = ell_column_split(
            EllMatrix(ell_m.indices.to(torch.int32),
                      ell_m.values.to(torch.float32), d), m)
        X = (fse.indices, fse.values)
        sq_norms = fse.row_sq_norms()
        w_shape, extra = (m, fse.d_loc + 1), dict(m=m, d_loc=fse.d_loc)
    elif ell:
        n, d = X_host.n_rows, X_host.n_features
        cols = X_host.indices.to(dev, torch.int32).contiguous()
        vals = X_host.values.to(dev, torch.float32).contiguous()
        X, w_shape, extra = (cols, vals), (d + 1,), {}
        sq_norms = torch.sum(vals * vals, dim=1)
    else:
        X = torch.as_tensor(X_host, dtype=torch.float32,
                            device=dev).contiguous()
        n, d = X.shape
        w_shape, extra = (d,), {}
        sq_norms = torch.sum(X * X, dim=1)
    if n < 1:
        raise ValueError("X has no rows")
    if ell or two_d:
        cols = X[0]
        lim = extra.get("d_loc", d)
        if not (0 <= int(cols.min()) and int(cols.max()) <= lim):
            raise ValueError(f"ELL column ids must lie in [0, {lim}]")
    return SolverSetup(
        loss=loss, n=n, d=d, n_loc=n, n_blocks=_n_blocks(n, block_size),
        block_size=int(block_size), w_shape=w_shape, ell=ell or two_d, X=X,
        sq_norms=sq_norms, delay_rounds=int(delay_rounds),
        gap_every=max(int(gap_every), 1), record=record, seed=int(seed),
        device=dev, two_d=two_d, fused=fused, overlap=overlap_on, **extra)


def _init_alpha_w(setup: SolverSetup, alpha0=None, w0=None):
    """(α, w) for a solve — zeros, or a warm start from carried state.
    A carried ``alpha0``/``w0`` *shorter* than n/d is the streaming-
    append warm start: old coordinates keep their values, new ones
    start at 0.  On a 2-D mesh a (d,) ``w0`` is re-blocked onto the
    shards' slices."""
    dev = setup.device
    alpha = torch.zeros((setup.n,), dtype=torch.float32, device=dev)
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
    """Back to user coordinates: drop the dummy slot, and on a 2-D mesh
    stitch ŵ out of the shards' slices."""
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


def _reject_unported(*, mesh, pod_delay_rounds, shrink_every, repack,
                     adaptive, multitask, pipeline):
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
    if mesh.shape["data"] > 1:
        raise NotImplementedError(
            f"data={mesh.shape['data']}: p > 1 data shards are ROADMAP "
            "A′.1, not yet ported; the port runs one data shard")
    if shrink_every or repack is True or adaptive:
        where = "A′.2 on the 2-D mesh" if "model" in axes else "A′.2"
        raise NotImplementedError(
            "shrink_every, repack and adaptive (self-tuning) are ROADMAP "
            f"A.7 ({where}), not yet ported")
    if not pipeline:
        raise NotImplementedError(
            "pipeline=False (the per-epoch host driver) is ROADMAP A′.12, "
            "not yet ported")


def _as_blocks(blocks, *, epochs, n_blocks, block_size, n, device):
    blocks = torch.as_tensor(blocks, dtype=torch.int32, device=device)
    want = (epochs, n_blocks, block_size)
    if tuple(blocks.shape) != want:
        raise ValueError(f"blocks must have shape {want}, got "
                         f"{tuple(blocks.shape)}")
    if not (0 <= int(blocks.min()) and int(blocks.max()) < n):
        raise ValueError(f"blocks must hold row ids in [0, {n})")
    return blocks


def _block_schedule(setup: SolverSetup, blocks, epochs: int):
    """``draw(e)``: epoch e's (n_blocks, B) row ids — from ``blocks`` (an
    epoch past the schedule repeats its last one: only the overlapped
    round's peek past the final epoch asks, and discards it) or through
    the reference's key chain, ``PRNGKey(seed)`` then per epoch
    ``key, sub = split(key)``."""
    if blocks is not None:
        blocks = _as_blocks(blocks, epochs=epochs, n_blocks=setup.n_blocks,
                            block_size=setup.block_size, n=setup.n,
                            device=setup.device)
        return lambda e: blocks[min(e, epochs - 1)]
    key, subs = prng.PRNGKey(setup.seed, device=setup.device), []
    for _ in range(epochs + 1):  # + the peek past the final epoch
        key, sub = prng.split(key)
        subs.append(sub)

    def draw(e):
        return _device_block_perm(subs[e], 0, 1, setup.n_loc, setup.n,
                                  setup.n_blocks, setup.block_size)

    return draw


def _rounds_1d(setup: SolverSetup, draw):
    bu = _block_update_1d(setup.loss, setup.ell)
    engine = functools.partial(bu, setup.X, setup.sq_norms)

    def rounds(e, alpha, w, dw):
        return _scan_rounds(engine, alpha, w, dw, draw(e),
                            setup.delay_rounds)

    return rounds


def _rounds_2d(setup: SolverSetup, draw, w0):
    """The 2-D round loop: eager (``_scan_rounds`` over the unfused or
    fused engine) or overlapped, whose in-flight (base, Gram) is carried
    across epochs — its prologue is the first block's, against ``w0``."""
    cols, vals = setup.X
    # B4's workspaces on the card: one for the eager round, two that
    # alternate for the overlapped one (B4 of block t + 1 runs before B5
    # of block t, which reads block t's buckets)
    workspaces = (None, None)
    if setup.fused and setup.device.type == "cuda":
        workspaces = tuple(
            gram_workspace(setup.m, setup.block_size, cols.shape[2],
                           setup.w_shape[1], setup.device)
            for _ in range(2 if setup.overlap else 1))
    if not setup.overlap:
        bu = _block_update_2d(setup.loss, setup.fused, workspaces[0])
        engine = functools.partial(bu, cols, vals, setup.sq_norms)

        def rounds(e, alpha, w, dw):
            return _scan_rounds(engine, alpha, w, dw, draw(e),
                                setup.delay_rounds)

        return rounds
    fns = _overlap_round_fns(cols, vals, setup.sq_norms, setup.loss)
    carry = {"inflight": (*fns[0](w0, draw(0)[0], workspaces[0]),
                          workspaces[0])}

    def rounds(e, alpha, w, dw):
        alpha, w, dw, carry["inflight"] = _scan_rounds_overlap(
            *fns, alpha, w, dw, draw(e), carry["inflight"], draw(e + 1)[0],
            workspaces)
        return alpha, w, dw

    return rounds


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
    """PASSCoDe-Atomic over one ``data`` shard on ``device`` (the card by
    default).  ``X_host``: a dense (n, d) tensor or an ``EllMatrix`` (the
    sparse fast path — per-update work O(k_max) instead of O(d)).

    ``mesh`` (a ``SolverMesh``; ``solver_mesh_2d(model=m)``) or
    ``mesh_axes`` picks the path: ``("data",)`` the 1-D solver,
    ``("data", "model")`` the 2-D feature-sharded solver over m shards
    (``mesh_axes`` alone means m = 1).  ``use_kernel``: "auto"
    (default), True or False — on the 1-D mesh the device alone decides
    (the CUDA kernels on the card, their plain versions on the CPU); on
    the 2-D mesh see the module docstring.  False raises on the card.

    ``delay_rounds ≥ 1`` folds each round's Δw in one round late (the
    reference's stale view; at p = 1 it runs the same updates);
    ``overlap`` ("auto", True, False) double-buffers the fused 2-D round
    (``pipeline_overlap``).  ``gap_every``: with ``record``, the duality
    gap and ‖w(α) − ŵ‖ every that many epochs plus the final one, kept
    on the device.  ``alpha0``/``w0`` warm-start the solve; ``y`` (n,)
    ±1 labels are validated and folded into X at the mouth.  The blocks
    are drawn through the reference's key chain from ``seed``;
    ``blocks`` replaces the draw with an explicit (epochs, n_blocks, B)
    schedule of row ids.  The knobs after ``blocks`` are the
    reference's; any value outside the ported slices that would act
    raises ``NotImplementedError`` naming its ROADMAP item
    (``prepare_solver``).
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
    if setup.two_d:
        rounds = _rounds_2d(setup, draw, w)
        gap = _make_gap_2d(setup.loss, *setup.X)
    else:
        rounds = _rounds_1d(setup, draw)
        gap = _make_gap_1d(setup.loss, setup.X, setup.ell, setup.w_shape[0])
    alpha, w, dw, gaps, eps = _epoch_scan(
        rounds, gap, alpha, w, torch.zeros_like(w), epochs=epochs,
        gap_every=setup.gap_every, record=record)
    if setup.delay_rounds > 0:
        w = w + dw  # flush the in-flight aggregate
    active = torch.ones_like(gaps)
    delay = torch.full_like(gaps, float(setup.delay_rounds))
    return _finalize(setup, alpha, w, gaps, epochs, eps, active, delay)


def sharded_passcode_feature(X_host, loss, *, mesh=None, epochs: int = 10,
                             seed: int = 0):
    """The reference's back-compat shim (one n-row block per epoch on the
    2-D mesh).  Not ported: its B = n would need an n × n Gram."""
    raise NotImplementedError(
        "sharded_passcode_feature (one block of B = n rows, an n × n Gram) "
        "is ROADMAP A′.12, not yet ported; call sharded_passcode_solve "
        "with mesh=solver_mesh_2d(model=m)")
