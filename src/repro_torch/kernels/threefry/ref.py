"""Plain PyTorch threefry2x32, operation for operation what
``csrc/threefry.cu`` computes.

Words are int64 tensors holding uint32 values. The rotated word is
masked back to 32 bits every round (a left shift of it by at most 29
stays below 2^61); the other word only collects sums, below 2^37 after
the 20 rounds, and is masked once at the end, which leaves its low 32
bits as they would be. So nothing overflows int64. Integer arithmetic
gives the same bits on every device, and these are the bits of
``jax.random`` with ``jax_threefry_partitionable`` on
(``jax/_src/prng.py``, ``_threefry2x32_lowering`` and
``iota_2x32_shape``).

Each function takes ``keys`` ``(R, 2)`` and a counter range ``[offset,
offset + n)`` per key row, as the kernel does; ``core/prng.py`` shapes
them into the ``jax.random`` API.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on broadcastable int64 words: the key
    ``(k0, k1)`` hashes the counter ``(x0, x1)``; returns the two output
    words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & MASK32
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 += x1
            x1 = ((x1 << r) | (x1 >> (32 - r))) ^ x0
            x1 &= MASK32
        x0 += ks[(block + 1) % 3]
        x1 += ks[(block + 2) % 3] + block + 1
        x1 &= MASK32
    return x0 & MASK32, x1


def _hash(keys: torch.Tensor, n: int, offset: int = 0):
    """Both output words for counters ``offset + i``, ``i < n``, under
    every key row: two ``(R, n)`` tensors."""
    c = torch.arange(offset, offset + n, dtype=torch.int64,
                     device=keys.device)
    return threefry2x32(keys[:, :1], keys[:, 1:], c >> 32, c & MASK32)


def bits_ref(keys: torch.Tensor, n: int, offset: int = 0,
             pair: bool = False) -> torch.Tensor:
    """``(R, n, 2)`` word pairs (new keys, as ``split`` makes them) or,
    without ``pair``, ``(R, n)`` 32-bit draws ``w0 ^ w1``."""
    w0, w1 = _hash(keys, n, offset)
    return torch.stack((w0, w1), dim=-1) if pair else w0 ^ w1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1): the top 23 bits as the mantissa of a number in
    [1, 2), minus 1 (exact)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def bernoulli_ref(keys: torch.Tensor, n: int, p: float) -> torch.Tensor:
    """``(R, n)`` bool: uniform < float32(p)."""
    return uniform_from_bits(bits_ref(keys, n)) < float(np.float32(p))


def _mulmod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b mod 2^32 for 32-bit a, b, in 16-bit halves of b so that no
    product exceeds 2^48."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & MASK32


def randint_ref(keys: torch.Tensor, n: int, maxval: torch.Tensor,
                minval: int = 0) -> torch.Tensor:
    """``(R, n)`` int64 in [minval, maxval[r]) as ``jax.random.randint``
    draws them in int32 (``jax/_src/random.py``, ``_randint``): two words
    from the key's split halves, folded modulo the span with the
    multiplier 2^32 mod span (uint32 arithmetic, wrapping as there).
    ``maxval`` ``(R,)``; a span ≤ 0 returns ``minval``."""
    halves = bits_ref(keys, 2, pair=True)                  # split(key)
    hi = bits_ref(halves[:, 0], n)
    lo = bits_ref(halves[:, 1], n)
    maxval = maxval.to(torch.int64).reshape(-1, 1)
    span = torch.where(maxval <= minval, torch.ones_like(maxval),
                       (maxval - minval) & MASK32)
    mult = (((65536 % span) ** 2) & MASK32) % span
    off = (_mulmod32(hi % span, mult) + lo % span) & MASK32
    return minval + off % span
