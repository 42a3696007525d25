"""Data-parallel PASSCoDe-Atomic on one GPU — the 1-D ``("data",)``
pipelined path of ``repro/core/sharded.py`` at p = 1.

The reference shards rows over p devices; each device runs a *block* of
B locally-sequential DCD updates against its replica of w, then the
per-device Δw are psummed (atomic semantics, staleness τ ≤ B·(p−1)), or
folded in one round late with ``delay_rounds ≥ 1``.  This slice is one
shard, p = 1, which is what the reference runs on one chip: the psum is
the identity and the solve is serial DCD in the block-draw order.  The
round structure is kept exactly — one block-engine call per round,
returning (α, Δw = w_new − w), then w += Δw — because the Δw round trip
rounds differently from carrying w, and parity with the reference
relies on doing the same.

Per round the block engine is the B1 wrapper
(``repro_torch.kernels.ops.dcd_ell_block_update``) on an ``EllMatrix``,
or the B2 wrapper (``dcd_block_update``) on a dense X.  Each launches
its CUDA kernel for tensors on the card and runs the kernel's plain
version for tensors on the CPU; that is the one place where the two
part.

Each epoch draws its blocks (``_device_block_perm``) from a seeded
``torch.Generator`` on the device — a different stream from the
reference's ``jax.random`` chain — or takes them from ``blocks=``, an
explicit (epochs, n_blocks, B) schedule, which is how a test feeds both
packages the same updates.  Duality gaps and the backward-error metric
‖w(α) − ŵ‖ are recorded into preallocated device buffers every
``gap_every`` epochs (and at the last), so nothing syncs with the host
until the solve returns.

Knobs of the reference outside this slice — shrinking, repacking, the
adaptive delay, pods, the overlapped round, a 2-D mesh, multi-task
labels — raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.data.sparse import EllMatrix
from repro_torch.dist.mesh import resolve_device
from repro_torch.kernels.ops import dcd_block_update, dcd_ell_block_update


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
    """``use_kernel`` ∈ {"auto", True, False}.  The block engines decide
    by device alone — the kernel for CUDA tensors, its plain version for
    CPU tensors — so every value gives the same solve; ``False`` (the
    plain engines) is refused on the card, where a CUDA tensor never
    reaches a plain engine."""
    if use_kernel not in ("auto", True, False):
        raise ValueError(f"use_kernel must be 'auto', True or False, got "
                         f"{use_kernel!r}")
    if not use_kernel and device.type == "cuda":
        raise ValueError(
            "use_kernel=False selects the plain engines, which are the CPU "
            "path; on CUDA the solver runs the kernels")


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


def _n_blocks(n_loc: int, block_size: int) -> int:
    """Blocks per shard per epoch — rounded UP so an epoch is a full
    pass; the tail block revisits early rows of the draw."""
    return max(-(-n_loc // block_size), 1)


def _device_block_perm(gen, my: int, n_loc: int, n_rows: int,
                       n_blocks: int, block_size: int):
    """Shard ``my``'s masked block permutation for one epoch: the shard
    owns global rows [my·n_loc, (my+1)·n_loc), of which the first
    v = clip(n_rows − my·n_loc, 1, n_loc) are real."""
    v = min(max(n_rows - my * n_loc, 1), n_loc)
    return _device_block_perm_v(gen, n_loc, v, n_blocks, block_size)


def _device_block_perm_v(gen, n_loc: int, v: int, n_blocks: int,
                         block_size: int):
    """The draw core: a permutation of n_loc with the invalid ids
    (≥ v) stable-sorted to the back, cycled through the valid prefix
    over n_blocks·B slots.  Returns (n_blocks, B) int32."""
    dev = gen.device
    m = n_blocks * block_size
    perm = torch.randperm(n_loc, generator=gen, device=dev)
    order = torch.argsort((perm >= v).to(torch.int8), stable=True)
    sel = perm[order][torch.arange(m, device=dev) % v]
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


def _epoch_scan(rounds, gap, alpha, w, dw, draw_perm, *, epochs: int,
                gap_every: int, record: bool):
    """The static epoch loop: draw this shard's blocks, run the rounds,
    and record the gap and ‖w(α) − ŵ‖ into preallocated device
    buffers.  Returns (α, w, dw, gaps, eps)."""
    n_gaps = _gap_slots(epochs, gap_every) if record else 0
    gaps = torch.zeros((n_gaps,), dtype=torch.float32, device=w.device)
    epsb = torch.zeros((n_gaps,), dtype=torch.float32, device=w.device)
    slot = 0
    for e in range(epochs):
        alpha, w, dw = rounds(alpha, w, dw, draw_perm(e))
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
    w_len: int  # primal length: d + 1 (ELL, dummy slot) or d (dense)
    ell: bool
    X: object  # (cols, vals) or dense (n, d)
    sq_norms: torch.Tensor
    delay_rounds: int
    gap_every: int
    record: bool
    seed: int
    device: torch.device


def prepare_solver(X_host, loss, *, block_size: int = 64,
                   delay_rounds: int = 0, seed: int = 0,
                   record: bool = True, use_kernel="auto",
                   gap_every: int = 1, device=None) -> SolverSetup:
    """Resolve the knobs, size the blocks and place the dataset on the
    device — the 1-D half of the reference's ``prepare_solver``.  No
    lane padding and, at p = 1, no row padding: the shard is X itself."""
    dev = resolve_device(device)
    _check_use_kernel(use_kernel, dev)
    if int(block_size) < 1:
        raise ValueError(f"block_size must be ≥ 1, got {block_size}")
    if int(delay_rounds) < 0:
        raise ValueError(f"delay_rounds must be ≥ 0, got {delay_rounds}")
    ell = isinstance(X_host, EllMatrix)
    if ell:
        n, d = X_host.n_rows, X_host.n_features
        cols = X_host.indices.to(dev, torch.int32).contiguous()
        vals = X_host.values.to(dev, torch.float32).contiguous()
        if n and not (0 <= int(cols.min()) and int(cols.max()) <= d):
            raise ValueError(f"ELL column ids must lie in [0, {d}]")
        X, w_len = (cols, vals), d + 1
        sq_norms = torch.sum(vals * vals, dim=1)
    else:
        X = torch.as_tensor(X_host, dtype=torch.float32,
                            device=dev).contiguous()
        n, d = X.shape
        w_len = d
        sq_norms = torch.sum(X * X, dim=1)
    if n < 1:
        raise ValueError("X has no rows")
    return SolverSetup(
        loss=loss, n=n, d=d, n_loc=n, n_blocks=_n_blocks(n, block_size),
        block_size=int(block_size), w_len=w_len, ell=ell, X=X,
        sq_norms=sq_norms, delay_rounds=int(delay_rounds),
        gap_every=max(int(gap_every), 1), record=record, seed=int(seed),
        device=dev)


def _init_alpha_w(setup: SolverSetup, alpha0=None, w0=None):
    """(α, w) for a solve — zeros, or a warm start from carried state.
    A carried ``alpha0``/``w0`` *shorter* than n/d is the streaming-
    append warm start: old coordinates keep their values, new ones
    start at 0."""
    dev = setup.device
    alpha = torch.zeros((setup.n,), dtype=torch.float32, device=dev)
    if alpha0 is not None:
        a0 = torch.as_tensor(alpha0, dtype=torch.float32,
                             device=dev).reshape(-1)[:setup.n]
        alpha[: a0.shape[0]] = a0
    w = torch.zeros((setup.w_len,), dtype=torch.float32, device=dev)
    if w0 is not None:
        v0 = torch.as_tensor(w0, dtype=torch.float32,
                             device=dev).reshape(-1)[:setup.d]
        w[: v0.shape[0]] = v0
    return alpha, w


def _finalize(setup: SolverSetup, alpha, w, gaps, epochs, eps=None,
              active=None, delay=None):
    """Slice the solve back to user coordinates (drop the dummy slot)."""
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


def _reject_unported(*, mesh_axes, pod_delay_rounds, overlap, shrink_every,
                     repack, adaptive, y):
    """The reference's knobs outside this slice: each raises, naming the
    ROADMAP item that ports it; none is silently ignored."""
    axes = tuple(mesh_axes)
    if y is not None and len(getattr(y, "shape", ())) == 2:
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
    if axes != ("data",):
        raise NotImplementedError(
            f"mesh_axes={axes}: the 2-D feature-sharded path is ROADMAP "
            "A.8, not yet ported; this slice runs the 1-D ('data',) path")
    if overlap is True:
        raise NotImplementedError(
            "overlap=True (the overlapped 2-D round) is ROADMAP A.8, not "
            "yet ported")
    if shrink_every or repack is True or adaptive:
        raise NotImplementedError(
            "shrink_every, repack and adaptive (self-tuning) are ROADMAP "
            "A.7, not yet ported")


def _as_blocks(blocks, *, epochs, n_blocks, block_size, n, device):
    blocks = torch.as_tensor(blocks, dtype=torch.int32, device=device)
    want = (epochs, n_blocks, block_size)
    if tuple(blocks.shape) != want:
        raise ValueError(f"blocks must have shape {want}, got "
                         f"{tuple(blocks.shape)}")
    if not (0 <= int(blocks.min()) and int(blocks.max()) < n):
        raise ValueError(f"blocks must hold row ids in [0, {n})")
    return blocks


def sharded_passcode_solve(
    X_host,
    loss,
    *,
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
    mesh_axes: tuple = ("data",),
    pod_delay_rounds: int = 0,
    overlap="auto",
    shrink_every: int = 0,
    repack="auto",
    adaptive: bool = False,
) -> ShardedResult:
    """PASSCoDe-Atomic over one ``data`` shard on ``device`` (the card by
    default).  ``X_host``: a dense (n, d) tensor or an ``EllMatrix`` (the
    sparse fast path — per-update work O(k_max) instead of O(d)).

    ``use_kernel``: "auto" (default), True or False.  The device alone
    decides: the CUDA kernels on the card, their plain versions on the
    CPU; False (the plain engines) raises on the card.

    ``delay_rounds ≥ 1`` folds each round's Δw in one round late (the
    reference's stale view; at p = 1 it runs the same updates).
    ``gap_every``: with ``record``, the duality gap and ‖w(α) − ŵ‖ every
    that many epochs plus the final one, kept on the device.
    ``alpha0``/``w0`` warm-start the solve; ``y`` (n,) ±1 labels are
    validated and folded into X at the mouth.  ``blocks`` replaces the
    seeded draw with an explicit (epochs, n_blocks, B) schedule of row
    ids.  The knobs after ``blocks`` are the reference's; any value
    outside this slice raises ``NotImplementedError``.
    """
    _reject_unported(mesh_axes=mesh_axes, pod_delay_rounds=pod_delay_rounds,
                     overlap=overlap, shrink_every=shrink_every,
                     repack=repack, adaptive=adaptive, y=y)
    dev = resolve_device(device)
    X_host = X_host.to(dev) if isinstance(X_host, EllMatrix) else \
        torch.as_tensor(X_host, dtype=torch.float32, device=dev)
    X_host = _validate_solver_inputs(X_host, y, loss)
    setup = prepare_solver(X_host, loss, block_size=block_size,
                           delay_rounds=delay_rounds, seed=seed,
                           record=record, use_kernel=use_kernel,
                           gap_every=gap_every, device=dev)
    if blocks is not None:
        blocks = _as_blocks(blocks, epochs=epochs, n_blocks=setup.n_blocks,
                            block_size=setup.block_size, n=setup.n,
                            device=dev)
        draw = blocks.__getitem__
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(setup.seed)

        def draw(e):
            return _device_block_perm(gen, 0, setup.n_loc, setup.n,
                                      setup.n_blocks, setup.block_size)

    bu = _block_update_1d(setup.loss, setup.ell)
    rounds = functools.partial(
        _scan_rounds,
        lambda a, w_eff, idx: bu(setup.X, setup.sq_norms, a, w_eff, idx),
        delay_rounds=setup.delay_rounds)

    gap = _make_gap_1d(setup.loss, setup.X, setup.ell, setup.w_len)
    alpha, w = _init_alpha_w(setup, alpha0, w0)
    alpha, w, dw, gaps, eps = _epoch_scan(
        rounds, gap, alpha, w, torch.zeros_like(w), draw, epochs=epochs,
        gap_every=setup.gap_every, record=record)
    if setup.delay_rounds > 0:
        w = w + dw  # flush the in-flight aggregate
    active = torch.ones_like(gaps)
    delay = torch.full_like(gaps, float(setup.delay_rounds))
    return _finalize(setup, alpha, w, gaps, epochs, eps, active, delay)
