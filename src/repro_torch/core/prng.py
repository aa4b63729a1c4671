"""``jax.random``'s threefry2x32 sampler in PyTorch, bit for bit.

The reference draws every minibatch and dropout mask from threefry keys
(``jax_threefry_partitionable`` on). This module gives the functions it
uses with the same bits: a key is an int64 tensor whose last axis holds
the two uint32 words, and every function takes a batch of keys
``(..., 2)``, so one call serves every zone slot or cohort client. Keys
live on the device, so a captured CUDA graph draws anew on each replay.

On a CUDA tensor each function is one launch of ``kernels/threefry``
(:func:`draws` makes a round's batch indices and keep masks in one); on
the CPU the same arithmetic runs as plain integer ops
(``kernels/threefry/ref.py``). Integer arithmetic gives the same bits on
every device, so a seed trains alike on the card and on the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.threefry import ops
from ..kernels.threefry.ref import MASK32, MaskSpec, uniform_from_bits
from .markov import round_keys


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a ``(2,)`` (or ``(..., 2)`` for an
    array of seeds) int64 tensor on ``device``."""
    return torch.as_tensor(round_keys(seed), device=device)


def _rows(key: torch.Tensor) -> torch.Tensor:
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key's last axis holds its two words, got "
                         f"shape {tuple(key.shape)}")
    return key.reshape(-1, 2).contiguous()


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` → ``(..., num, 2)``."""
    out = ops.threefry_bits(_rows(key), num, pair=True)
    return out.reshape(key.shape[:-1] + (num, 2))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter ``data``."""
    out = ops.threefry_bits(_rows(key), 1, offset=int(data) & MASK32,
                            pair=True)
    return out.reshape(key.shape)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit draws ``(..., *shape)`` (int64): w0 ^ w1 of the counters'
    hashes, the counter being the row-major index into ``shape``."""
    shape = tuple(shape)
    out = ops.threefry_bits(_rows(key), math.prod(shape))
    return out.reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [0, 1)."""
    return uniform_from_bits(random_bits(key, shape))


#: Giles' single-precision erfinv coefficients, XLA's ``ErfInv`` for
#: float32 (w = −log1p(−u²); w < 5 and w ≥ 5), highest order first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(u: torch.Tensor) -> torch.Tensor:
    """float32 erf⁻¹ by the polynomial XLA evaluates (not
    ``torch.erfinv``'s rational form): within a few ulp of
    ``jax.lax.erf_inv``, whose ``log1p`` rounds its own way."""
    w = -torch.log1p(-u * u)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(u.abs() == 1.0, u * math.inf, p * u)


#: ``jax.random.normal``'s uniform interval, (nextafter(−1, 0), 1) in fp32
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_SPAN = float(np.float32(1.0) - np.float32(_NORMAL_LO))


def _normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    f = uniform_from_bits(bits)
    u = torch.clamp(f * _NORMAL_SPAN + _NORMAL_LO, min=_NORMAL_LO)
    return float(np.float32(math.sqrt(2.0))) * erf_inv(u)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32: √2·erf⁻¹(u), u uniform
    on [nextafter(−1, 0), 1) from the key's bits with the reference's
    scale, shift and clamp. The bits are exact; :func:`erf_inv` leaves a
    few ulp against XLA's."""
    return _normal_from_bits(random_bits(key, shape))


#: values a block of :func:`normal_blocks` holds at most (its int64 bits
#: take 32 MiB), unless a single row is longer
NORMAL_BLOCK = 1 << 22


def normal_blocks(key: torch.Tensor, shape, block: int = NORMAL_BLOCK):
    """``normal(key, shape)`` for one key ``(2,)``, a block of rows at a
    time: yields ``(r0, r1, rows)``, ``rows`` the draw's rows ``r0:r1``
    along its last axis (``(r1 − r0, shape[-1])``; a 0- or 1-D shape is
    one row), at most ``block`` values unless one row holds more. Element
    i of a draw hashes the counter i, its row-major index as a 64-bit
    (high, low) word pair (JAX's partitionable threefry), so rows r0:r1
    are the counters from r0·row on, a draw may pass 2^32 values (kimi's
    (384, 7168, 2048) experts), and no block makes the whole draw's
    bits."""
    shape = tuple(shape)
    if key.shape != (2,):
        raise ValueError(f"one key (2,), got {tuple(key.shape)}")
    total, row = math.prod(shape), (shape[-1] if shape else 1)
    if total > 2**64:
        raise ValueError(f"a draw of {total} values passes the 64-bit "
                         f"counters")
    rows = total // row if row else 0
    step = max(1, block // max(row, 1))
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        bits = ops.threefry_bits(key.reshape(1, 2), (r1 - r0) * row,
                                 offset=r0 * row)
        yield r0, r1, _normal_from_bits(bits.reshape(r1 - r0, row))


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: bool ``(..., *shape)``."""
    shape = tuple(shape)
    _, (out,) = ops.threefry_draws(_rows(key), masks=(MaskSpec(shape, p),),
                                   fold=False)
    return out.reshape(key.shape[:-1] + shape)


def randint(key: torch.Tensor, shape, minval: int, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 draws,
    returned as int64). ``maxval`` is an int or a tensor broadcast over
    the keys' leading axes: one span per key row."""
    shape = tuple(shape)
    lead = key.shape[:-1]
    rows = _rows(key)
    if isinstance(maxval, torch.Tensor):
        maxval = maxval.to(torch.int64).expand(lead).reshape(-1)
    else:   # a fill, not a host copy: safe inside a captured graph
        maxval = torch.full((rows.shape[0],), int(maxval),
                            dtype=torch.int64, device=key.device)
    out, _ = ops.threefry_draws(rows, batch=math.prod(shape), spans=maxval,
                                minval=minval)
    return out.reshape(lead + shape)


def draws(keys: torch.Tensor, *, split: int | None = None, batch: int = 0,
          spans: torch.Tensor | None = None,
          clients: torch.Tensor | None = None, minval: int = 0,
          masks: tuple[MaskSpec, ...] = ()):
    """A round's batch indices and keep masks in one launch. The leaves
    are ``keys`` ``(..., 2)`` or, with ``split``, ``leaf[j, ...] =
    jax.random.split(keys[...], split)[j]``; with ``keys`` ``(m, 2)`` that
    is ``jnp.swapaxes(vmap(lambda k: split(k, Z))(keys), 0, 1)``. Under
    each leaf, whose client is ``clients[l % m]`` for the leaf's flat
    index l (``spans[l % S]`` itself without ``clients``):

    * ``idx`` ``(*lead, batch)``: ``jax.random.randint(leaf, (batch,),
      minval, spans[client])``;
    * mask i ``(*lead, *spec.out_shape)``: ``jax.random.bernoulli(
      jax.random.fold_in(leaf, i + 1), spec.p, spec.shape)``, the last
      axis moved to second with ``spec.channels_first``.

    ``lead`` is ``(split, *keys.shape[:-1])``, or ``keys.shape[:-1]``
    without ``split``. Returns ``(idx, masks)``, ``masks`` a tuple."""
    lead = keys.shape[:-1] if split is None else (split, *keys.shape[:-1])
    masks = tuple(masks)
    if spans is not None:
        spans = spans.to(torch.int64).contiguous()
    if clients is not None:
        clients = clients.to(torch.int64).reshape(-1).contiguous()
    idx, keep = ops.threefry_draws(_rows(keys), split=split, batch=batch,
                                   spans=spans, clients=clients,
                                   minval=minval, masks=masks)
    return (idx.reshape(*lead, batch),
            tuple(k.reshape(*lead, *spec.out_shape)
                  for k, spec in zip(keep, masks)))
