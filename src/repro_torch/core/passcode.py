"""PASSCoDe — Algorithm 2 with the Lock / Atomic / Wild memory models, the
counterpart of ``repro/core/passcode.py``.

The reference simulates the memory semantics deterministically from a
seed, and so does the port, update for update:

  * an epoch is ``n // n_threads`` rounds of ``n_threads`` coordinate
    updates on disjoint coordinates (a permutation of [n] cut to a whole
    number of rounds, §3.3);
  * every update of a round reads the same stale view of w: the
    round-start w, minus the last ``delay`` rounds' increments;
  * the write-back is the memory model's:
      - ``lock``: the updates apply one by one, each seeing every earlier
        write — serial DCD over the round order, so one Lock epoch is
        one launch of the indexed DCD kernel over the whole order (B1 on
        an ``EllMatrix``, B2 on a dense X; ``core/dcd.py:dcd_epoch``);
      - ``atomic``: every δ_t·x_t is summed into w (stale reads, lossless
        writes);
      - ``wild``: for a feature written by ≥ 2 updates of a round, with
        probability ``conflict_rate`` only the last scheduled writer's
        increment survives (seeded last-writer-wins), so ŵ drifts from
        w̄ = Σ α_i x_i and the backward error of §4.2 applies.

The α update always lands; only w suffers conflicts.

Atomic and Wild are plain array code in the reference (gathers, one
batched δ, scatter-adds), and torch ops here.  Their draws are hashes of
the round keys, so an epoch's draws are made in a few batched ops before
the round loop: every round's schedule order (``permutation(korder,
p)``) and, for Wild, its conflict draw ``uniform(kconf, (d,))`` — on an
``EllMatrix`` only at the features the round touches (``uniform_at``;
element i of a draw is a hash of counter i alone).  The round loop makes
no host sync.  The key chain is the reference's: ``PRNGKey(seed)``, per
epoch ``key, sub = split(key)``, then ``kperm, kround = split(sub)``,
``permutation(kperm, n)`` and ``split(kround, rounds)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import prng
from repro_torch.core.dcd import DcdState, dcd_epoch
from repro_torch.core.objective import duality_gap, w_of_alpha
from repro_torch.data.sparse import EllMatrix, pad_primal, unpad_primal
from repro_torch.dist.mesh import resolve_device

MEMORY_MODELS = ("lock", "atomic", "wild")
# counters hashed at once by the conflict draw: bounds its int64
# temporaries (threefry keeps a few of the counters' size alive)
DRAW_CHUNK = 1 << 22


class PasscodeResult(NamedTuple):
    alpha: torch.Tensor  # α̂ — dual iterate
    w_hat: torch.Tensor  # ŵ — the maintained primal (predict with this!)
    w_bar: torch.Tensor  # w̄ = Σ α̂_i x_i (eq. 6)
    gaps: torch.Tensor  # nominal duality gap per epoch (from w̄)
    eps_norms: torch.Tensor  # ‖ε‖ = ‖w̄ − ŵ‖ per epoch
    epochs: int


def _round_indices(key, n, n_threads):
    """Disjoint per-thread coordinate streams: permute [n], reshape to
    (rounds, n_threads).  Truncates the ragged tail (< n_threads ids)."""
    perm = prng.permutation(key, n)
    rounds = n // n_threads
    return perm[: rounds * n_threads].reshape(rounds, n_threads)


def _round_schedule(round_keys, p: int):
    """Wild's per-round draws for all R rounds at once: each round key
    splits into (korder, kconf); returns the schedule positions
    ``permutation(korder, p)`` (R, p) and the conflict keys kconf
    (R, 2)."""
    sub = prng.split(round_keys)  # (R, 2, 2)
    return prng.permutation(sub[:, 0], p), sub[:, 1]


def _conflict_draws(kconf, counters):
    """u = ``uniform(kconf_r, (·,))`` at ``counters(s, e)`` — the
    counters of rounds s..e−1, (e − s, ...) — for every round, drawn in
    chunks of rounds; (R, ...) float32."""
    R = kconf.shape[0]
    if R == 0:
        return torch.empty(counters(0, 0).shape, dtype=torch.float32,
                           device=kconf.device)
    first = counters(0, 1)
    step = max(1, DRAW_CHUNK // max(1, first.numel()))
    out = torch.empty((R,) + tuple(first.shape[1:]), dtype=torch.float32,
                      device=kconf.device)
    for s in range(0, R, step):
        e = min(R, s + step)
        out[s:e] = prng.uniform_at(kconf[s:e], counters(s, e))
    return out


def _dense_conflicted(writers, u, rate):
    """Features written by ≥ 2 of the round's updates whose draw falls
    below the conflict rate: (d,) bool."""
    return (writers.sum(0) >= 2) & (u < rate)


def _ell_conflicted(ind, writers, u, rate, d1: int):
    """The same over the round's ELL entries: ``ind`` (p, k) column ids
    (padding d), ``writers`` (p, k), ``u`` (p, k) the draw at each
    entry's column.  Entries of one column carry one count and one draw,
    so scattering their verdicts writes one value per feature; (d1,)
    bool."""
    flat = ind.reshape(-1)
    n_writers = torch.zeros(d1, dtype=torch.int64, device=ind.device)
    n_writers.index_add_(0, flat, writers.reshape(-1).long())
    hit = (n_writers[ind] >= 2) & (u < rate)
    out = torch.zeros(d1, dtype=torch.bool, device=ind.device)
    return out.index_put_((flat,), hit.reshape(-1))


def _dense_wild(contrib, summed, position, u, rate):
    """Last-writer-wins on the conflicted features of a dense round."""
    writers = contrib != 0.0
    prio = torch.where(writers, position[:, None], -1)
    lww = torch.gather(contrib, 0, prio.argmax(0, keepdim=True))[0]
    return torch.where(_dense_conflicted(writers, u, rate), lww, summed)


def _ell_wild(ind, contrib, summed, position, u, rate):
    """Last-writer-wins on the conflicted features of an ELL round: the
    winner of a feature is its largest 1-based schedule position (a
    scatter-max), and only the winner's entry adds into ``lww``."""
    flat = ind.reshape(-1)
    writers = contrib != 0.0
    prio_sparse = torch.where(writers, position[:, None] + 1, 0)
    prio = torch.zeros(summed.shape, dtype=torch.int64, device=ind.device)
    prio.scatter_reduce_(0, flat, prio_sparse.reshape(-1), "amax")
    keep = prio_sparse == prio[ind]
    lww = torch.zeros_like(summed).index_add_(
        0, flat, torch.where(keep, contrib, 0.0).reshape(-1))
    conflicted = _ell_conflicted(ind, writers, u, rate, summed.shape[0])
    return torch.where(conflicted, lww, summed)


def _parallel_epoch(X, sq_norms, alpha, w, rounds_idx, round_keys, loss, *,
                    wild: bool, delay: int, conflict_rate: float):
    """Atomic (``wild=False``) or Wild over the rounds of ``rounds_idx``
    (R, p); ``w`` is (d,) for a dense X, the (d+1,) padded primal for an
    ``EllMatrix`` (slot d swallows the padding).  Returns new (α, w)."""
    ell = isinstance(X, EllMatrix)
    dev = w.device
    ids = rounds_idx.long()
    R, p = ids.shape
    alpha = alpha.clone()
    # the last `delay` rounds' increments, a ring: round r writes slot
    # r % delay, dropping the oldest as the reference's concatenate does
    hist = torch.zeros((max(delay, 1), w.shape[0]), dtype=w.dtype,
                       device=dev)
    if ell:
        cols, vals = X.indices.long(), X.values
    if wild:
        positions, kconf = _round_schedule(round_keys, p)
        rate = torch.tensor(conflict_rate, dtype=torch.float32, device=dev)
        if ell:
            u = _conflict_draws(kconf, lambda s, e: cols[ids[s:e]])
        else:
            # dense: the whole (d,) draw per round, R·d ≤ n·d / p values
            d = w.shape[0]
            arange = torch.arange(d, dtype=torch.int64, device=dev)
            u = _conflict_draws(kconf,
                                lambda s, e: arange.expand(e - s, d))
    for r in range(R):
        idx = ids[r]
        w_read = w - torch.sum(hist, dim=0) if delay > 0 else w
        if ell:
            ind, rows = cols[idx], vals[idx]  # (p, k)
            wx = torch.sum(w_read[ind] * rows, dim=1)
        else:
            rows = X[idx]  # (p, d)
            wx = rows @ w_read
        deltas = loss.delta(alpha[idx], wx, sq_norms[idx])
        contrib = deltas[:, None] * rows
        if ell:
            summed = torch.zeros_like(w).index_add_(
                0, ind.reshape(-1), contrib.reshape(-1))
        else:
            summed = torch.sum(contrib, dim=0)
        if not wild:
            w_delta = summed
        elif ell:
            w_delta = _ell_wild(ind, contrib, summed, positions[r], u[r],
                                rate)
        else:
            w_delta = _dense_wild(contrib, summed, positions[r], u[r], rate)
        w = w + w_delta
        alpha.index_add_(0, idx, deltas)
        if delay > 0:
            hist[r % delay] = w_delta
    return alpha, w


def _check_knobs(memory_model, n_threads, delay):
    if memory_model not in MEMORY_MODELS:
        raise ValueError(f"memory_model must be one of {MEMORY_MODELS}, "
                         f"got {memory_model!r}")
    if int(n_threads) < 1:
        raise ValueError(f"n_threads must be ≥ 1, got {n_threads}")
    if int(delay) < 0:
        raise ValueError(f"delay must be ≥ 0, got {delay}")


def _place(X, dev):
    if isinstance(X, EllMatrix):
        return X.to(dev)
    return torch.as_tensor(X, dtype=torch.float32, device=dev).contiguous()


def passcode_epoch(X, sq_norms, alpha, w_hat, key, loss, *,
                   n_threads: int = 4, memory_model: str = "atomic",
                   delay: int = 0, conflict_rate: float = 0.5,
                   device=None):
    """One epoch (≈ n updates) of Algorithm 2 under the given memory
    model, on ``device`` (the card unless the caller asks for the CPU).
    Returns new (α, ŵ)."""
    _check_knobs(memory_model, n_threads, delay)
    dev = resolve_device(device)
    X = _place(X, dev)
    sq_norms, alpha, w_hat, key = (t.to(dev) for t in (sq_norms, alpha,
                                                        w_hat, key))
    n = X.n_rows if isinstance(X, EllMatrix) else X.shape[0]
    kperm, kround = prng.split(key)
    rounds_idx = _round_indices(kperm, n, int(n_threads))
    if memory_model == "lock":
        state = dcd_epoch(X, sq_norms, DcdState(alpha, w_hat),
                          rounds_idx.reshape(-1).int(), loss)
        return state.alpha, state.w
    round_keys = prng.split(kround, rounds_idx.shape[0])
    kw = dict(wild=memory_model == "wild", delay=int(delay),
              conflict_rate=float(conflict_rate))
    if isinstance(X, EllMatrix):
        alpha, w_pad = _parallel_epoch(X, sq_norms, alpha, pad_primal(w_hat),
                                       rounds_idx, round_keys, loss, **kw)
        return alpha, unpad_primal(w_pad)
    return _parallel_epoch(X, sq_norms, alpha, w_hat, rounds_idx,
                           round_keys, loss, **kw)


def passcode_solve(X, loss, *, n_threads: int = 4,
                   memory_model: str = "atomic", epochs: int = 20,
                   seed: int = 0, delay: int = 0, conflict_rate: float = 0.5,
                   tol: float = 0.0, record: bool = True,
                   device=None) -> PasscodeResult:
    """Run PASSCoDe-{Lock,Atomic,Wild} for ``epochs`` epochs on
    ``device`` (the card unless the caller asks for the CPU).  With
    ``record``, the duality gap and ‖w̄ − ŵ‖ are read once per epoch (the
    epoch's one host sync); ``tol > 0`` stops once the gap is at most
    ``tol``."""
    _check_knobs(memory_model, n_threads, delay)
    dev = resolve_device(device)
    X = _place(X, dev)
    if isinstance(X, EllMatrix):
        n, d = X.n_rows, X.n_features
        sq_norms = X.row_sq_norms()
    else:
        n, d = X.shape
        sq_norms = torch.sum(X * X, dim=1)
    alpha = torch.zeros((n,), dtype=torch.float32, device=dev)
    w_hat = torch.zeros((d,), dtype=torch.float32, device=dev)
    key = prng.PRNGKey(seed, device=dev)
    gaps, eps_norms = [], []
    done = 0
    for e in range(epochs):
        key, sub = prng.split(key)
        alpha, w_hat = passcode_epoch(
            X, sq_norms, alpha, w_hat, sub, loss, n_threads=n_threads,
            memory_model=memory_model, delay=delay,
            conflict_rate=conflict_rate, device=dev)
        done = e + 1
        if record:
            g = float(duality_gap(alpha, X, loss))
            eps = float(torch.linalg.norm(w_of_alpha(X, alpha) - w_hat))
            gaps.append(g)
            eps_norms.append(eps)
            if tol > 0 and g <= tol:
                break
    w_bar = w_of_alpha(X, alpha)
    return PasscodeResult(alpha, w_hat, w_bar,
                          torch.tensor(gaps, dtype=torch.float32),
                          torch.tensor(eps_norms, dtype=torch.float32), done)
