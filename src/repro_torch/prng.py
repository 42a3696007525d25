"""The parts of ``jax.random`` the solvers draw from — ``PRNGKey``,
``split``, 32-bit random bits, ``permutation`` and float32 ``uniform`` —
bit-exact to the threefry2x32 implementation in its partitionable mode
(the default of jax 0.9), in torch ops on the key's device.

A key is a (2,) int64 tensor holding two uint32 words; every uint32
operation is carried in int64 and masked to 32 bits.  ``split``,
``random_bits``, ``permutation`` and ``uniform`` also take a stack of
keys, shape (..., 2), and draw for each key as ``jax.vmap`` of the
single-key draw would.  The algorithm:

* ``PRNGKey(seed)`` = (seed >> 32, seed & 0xFFFFFFFF);
* ``threefry2x32`` is Threefry-2x32 with 20 rounds: five groups of four
  add/rotate/xor rounds, rotations (13, 15, 26, 6) and (17, 29, 16, 24)
  in turn, the key schedule (k₁, k₂, k₁ ^ k₂ ^ 0x1BD11BDA) injected
  after each group together with the group number;
* ``split(key, num)`` hashes the counters (0, i), i < num: key i is the
  output word pair;
* ``random_bits(key, n)`` hashes the same counters and XORs the two
  output words;
* ``permutation(key, n)`` shuffles arange(n) by rounds of a stable sort
  on fresh 32-bit keys, ⌈3·ln n / ln(2³²−1)⌉ rounds, each round taking
  ``key, sub = split(key)`` and sorting on ``random_bits(sub, n)`` —
  ``lax.sort_key_val`` is stable, and so is the sort here, so tied keys
  keep their order as they do there;
* ``uniform(key, shape)`` hashes the flat counters as ``random_bits``
  does and keeps 23 bits of each as the mantissa of a float in [1, 2):
  ((bits >> 9) | 0x3F800000) read as float32, minus 1.  Element i of a
  draw depends on counter i alone, so ``uniform_at`` draws the elements
  at given counters without the rest;
* ``fold_in(key, data)`` hashes the one counter (0, data): key ``data``
  of ``split(key, data + 1)``;
* ``randint(key, shape, lo, hi)`` (int32) takes ``k1, k2 = split(key)``
  and 32 random bits of each, a and b, and with span = hi − lo and
  m = (2¹⁶ mod span)² mod span returns lo + ((a mod span)·m + b mod
  span) mod span, every step in wrapping uint32 arithmetic;
* ``gumbel(key, shape)`` (float32, mode "low") is −log(−log(u)) of
  ``uniform(key, shape, tiny, 1)``, tiny the smallest normal float32,
  each log XLA's CPU log (``xla_log``), not ``torch.log``;
* ``categorical(key, logits)`` is the argmax over the last axis of
  ``gumbel(key, logits.shape) + logits``, the first index on a tie.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def PRNGKey(seed: int, *, device=None) -> torch.Tensor:
    """The raw key of an integer seed: (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must lie in [0, 2**64), got {seed}")
    return torch.tensor([seed >> 32, seed & _M32], dtype=torch.int64,
                        device=device)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2); all int64 tensors holding uint32 values.  Returns the two
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(g + 1) % 3]) & _M32
        x2 = (x2 + ks[(g + 2) % 3] + g + 1) & _M32
    return x1, x2


def _hash(key: torch.Tensor, counters: torch.Tensor):
    """threefry2x32 of the counters (0, c) under ``key`` (..., 2), whose
    leading dims lead the counters' dims — the partitionable mode's
    iota over a flat shape (counters < 2³² here, so the high counter
    word is 0).  Returns the two output words, shaped as ``counters``."""
    k1, k2 = key[..., 0], key[..., 1]
    tail = (1,) * (counters.dim() - k1.dim())
    return threefry2x32(k1.reshape(k1.shape + tail),
                        k2.reshape(k2.shape + tail),
                        torch.zeros_like(counters), counters)


def _iota(key: torch.Tensor, n: int) -> torch.Tensor:
    """The counters 0..n-1 for each key of a stack: (..., n)."""
    lo = torch.arange(int(n), dtype=torch.int64, device=key.device)
    return lo.expand(*key.shape[:-1], int(n))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., num, 2) new keys of each key (..., 2)."""
    b1, b2 = _hash(key, _iota(key, num))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)``: (..., n) uint32 values
    (in int64)."""
    b1, b2 = _hash(key, _iota(key, n))
    return b1 ^ b2


def shuffle_rounds(n: int) -> int:
    """The sort rounds ``permutation`` takes for n elements."""
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(_M32)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: a permutation of arange(n) for
    each key (..., 2), (..., n) int64 on the key's device."""
    x = _iota(key, n)
    for _ in range(shuffle_rounds(n)):
        keys = split(key)
        key, sub = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(random_bits(sub, n), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for
    each key (..., 2): (..., *shape) float32."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return uniform_at(key, _iota(key, math.prod(shape)), minval,
                      maxval).reshape(tuple(key.shape[:-1]) + shape)


def uniform_at(key: torch.Tensor, counters: torch.Tensor,
               minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """The elements of a ``uniform`` draw at the given flat ``counters``
    (int64, each below the draw's size): for a key (2,),
    ``uniform_at(key, c) == uniform(key, (N,))[c]``.  A stack of keys
    (R, 2) draws row r of ``counters`` (R, ...) under key r.

    The float keeps 23 of the 32 bits as its mantissa in [1, 2), minus
    1; it is scaled to [minval, maxval) and clamped below at minval.
    XLA fuses the scale into one multiply-add rounded once; here it is
    formed in float64 (the float32 product is exact there) and rounded
    once to float32.  On [0, 1) the scale is exact either way."""
    b1, b2 = _hash(key, counters.to(torch.int64))
    bits = b1 ^ b2
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


_TINY = 1.1754943508222875e-38  # float32's smallest normal


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``: the hash
    of the counter (0, data), a (..., 2) key for each key (..., 2)."""
    data = int(data) & _M32
    c = torch.full(key.shape[:-1], data, dtype=torch.int64,
                   device=key.device)
    b1, b2 = _hash(key, c)
    return torch.stack([b1, b2], dim=-1)


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32 (jax's
    default without x64) for each key (..., 2): (..., *shape) int64
    values in [minval, maxval)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = math.prod(shape)
    lo, hi = int(minval), int(maxval)
    keys = split(key)
    higher = random_bits(keys[..., 0, :], n)
    lower = random_bits(keys[..., 1, :], n)
    span = 1 if hi <= lo else (hi - lo) & _M32
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    off = ((higher % span) * mult) & _M32
    off = ((off + lower % span) & _M32) % span
    return (lo + off).reshape(tuple(key.shape[:-1]) + shape)


# the Cephes polynomial of log(1 + x) on [√½ − 1, √2 − 1] that XLA's CPU
# backend evaluates for a float32 log, and the two parts of ln 2
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _fma(a, b, c):
    """a·b + c rounded once to float32: the float32 product is exact in
    float64, and the float64 sum is rounded to float32."""
    return (a.double() * b.double() + c.double()).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """The natural log of positive, finite, normal float32 values, bit
    for bit as XLA's CPU backend computes it (``jnp.log``): Cephes'
    range reduction to m ∈ [√½, √2) with m = 1 + x, its degree-8
    polynomial by fused multiply-adds, then x − x²/2 + x³·p(x) and the
    exponent's e·ln 2 in two parts.  ``torch.log`` is rounded
    correctly and parts from it by an ulp in about one value in twelve,
    which the Gumbel draw's log of a log magnifies."""
    f32 = torch.float32
    x = torch.clamp(x.to(f32), min=_TINY)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(f32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(f32)
    small = m < 0.707106781186547524
    e = e - small.to(f32)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = x * x
    x3 = x2 * x

    def c(v):
        return torch.full_like(x, v)

    y = _fma(x, c(_LOG_P[0]), c(_LOG_P[1]))
    y1 = _fma(x, c(_LOG_P[3]), c(_LOG_P[4]))
    y2 = _fma(x, c(_LOG_P[6]), c(_LOG_P[7]))
    y = _fma(y, x, c(_LOG_P[2]))
    y1 = _fma(y1, x, c(_LOG_P[5]))
    y2 = _fma(y2, x, c(_LOG_P[8]))
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    x = x - x2 * 0.5
    x = x + y
    return x + e * _LOG_Q2


def gumbel(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its default "low"
    mode for each key (..., 2): (..., *shape) float32, −log(−log(u)) with
    XLA's log (``xla_log``)."""
    u = uniform(key, shape, minval=_TINY, maxval=1.0)
    return -xla_log(-xla_log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, for
    one key (2,) and float32 logits (..., n): the argmax of
    ``gumbel(key, logits.shape) + logits``, int64 of shape (...,)."""
    g = gumbel(key, tuple(logits.shape))
    return torch.argmax(g + logits.to(torch.float32), dim=-1)
