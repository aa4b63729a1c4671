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
offset + n)`` per key row, as the kernel does; :func:`draws_ref` composes
them into a round's draws as ``threefry_draws`` makes them in one launch;
``core/prng.py`` shapes them into the ``jax.random`` API.
"""
from __future__ import annotations

import math
from typing import NamedTuple

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


class MaskSpec(NamedTuple):
    """A keep mask of ``threefry_draws``: ``bernoulli(key, p, shape)`` per
    leaf, ``shape`` being the reference's (channels-last). With
    ``channels_first`` the last axis is stored second, (N, H, W, C) as
    (N, C, H, W), the bits still following the reference's index."""

    shape: tuple[int, ...]
    p: float
    channels_first: bool = False

    @property
    def out_shape(self) -> tuple[int, ...]:
        """The stored shape of one leaf's mask."""
        if not self.channels_first:
            return tuple(self.shape)
        return (self.shape[0], self.shape[-1], *self.shape[1:-1])

    def dims(self) -> tuple[int, int, int]:
        """``(count, C, S)``: the kernel stores element (n, c, s) of
        ``(count / (C·S), C, S)`` from counter (n·S + s)·C + c; C = 1 keeps
        the reference's order."""
        count = math.prod(self.shape)
        if not self.channels_first:
            return count, 1, count
        return count, self.shape[-1], math.prod(self.shape[1:-1])


def draws_ref(keys: torch.Tensor, *, split: int | None = None,
              batch: int = 0, spans: torch.Tensor | None = None,
              clients: torch.Tensor | None = None, minval: int = 0,
              masks=(), fold: bool = True):
    """A round's draws under every leaf: the rows of ``keys`` or, with
    ``split``, each row's ``split(key, split)``, fan-out-major (leaf j·R +
    r is ``split(keys[r], split)[j]``). ``idx`` ``(leaves, batch)`` int64,
    leaf l's ``randint(leaf, (batch,), minval, spans[clients[l % m]])``
    (``spans[l % S]`` without ``clients``), and one ``(leaves,
    *spec.out_shape)`` bool mask per
    :class:`MaskSpec`, mask i drawn by ``bernoulli(fold_in(leaf, i + 1),
    p, shape)`` (under the leaf itself without ``fold``)."""
    leaves = keys if split is None else bits_ref(
        keys, split, pair=True).transpose(0, 1).reshape(-1, 2)
    n = leaves.shape[0]
    rows = torch.arange(n, device=keys.device)
    if batch:
        which = (rows % spans.shape[0] if clients is None
                 else clients[rows % clients.shape[0]])
        idx = randint_ref(leaves, batch, spans[which], minval)
    else:
        idx = torch.empty((n, 0), dtype=torch.int64, device=keys.device)
    out = []
    for i, spec in enumerate(masks):
        key = bits_ref(leaves, 1, i + 1, True).view(n, 2) if fold else leaves
        keep = bernoulli_ref(key, math.prod(spec.shape), spec.p)
        keep = keep.view(n, *spec.shape)
        if spec.channels_first:
            keep = keep.movedim(-1, 2).contiguous()
        out.append(keep)
    return idx, tuple(out)
