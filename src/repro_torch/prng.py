"""The parts of ``jax.random`` the solvers draw from — ``PRNGKey``,
``split``, 32-bit random bits and ``permutation`` — bit-exact to the
threefry2x32 implementation in its partitionable mode (the default of
jax 0.9), in torch ops on the key's device.

A key is a (2,) int64 tensor holding two uint32 words; every uint32
operation is carried in int64 and masked to 32 bits.  The algorithm:

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
  keep their order as they do there.
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


def _hash_counts(key: torch.Tensor, n: int):
    """threefry2x32 of the counters (0, i) for i < n — the partitionable
    mode's iota over a flat shape of n (n < 2³² here, so the high
    counter word is 0)."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (num, 2) new keys."""
    b1, b2 = _hash_counts(key, int(num))
    return torch.stack([b1, b2], dim=1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)``: n uint32 values (in
    int64)."""
    b1, b2 = _hash_counts(key, int(n))
    return b1 ^ b2


def shuffle_rounds(n: int) -> int:
    """The sort rounds ``permutation`` takes for n elements."""
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(_M32)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: a permutation of arange(n),
    int64 on the key's device."""
    x = torch.arange(int(n), dtype=torch.int64, device=key.device)
    for _ in range(shuffle_rounds(n)):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, n), stable=True).indices
        x = x[order]
    return x
