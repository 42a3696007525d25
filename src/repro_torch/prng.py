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
  at given counters without the rest.
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
