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
