"""Wrappers of the threefry2x32 kernels (``csrc/threefry.cu``).

Each takes ``keys`` ``(R, 2)`` int64 (uint32 words) and draws ``n``
counters per key row. A CUDA tensor launches the kernel or raises; only
tensors on the CPU take the plain version in :mod:`.ref`. Each wrapper
counts its own kernel launches in ``<wrapper>.launches``; a launch
recorded into a CUDA graph counts once, its replays not at all.

The kernels are built at first use by :func:`..._build.build` (``nvcc``
into ``build/`` beside this file, loaded with ``ctypes``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from .. import _build
from .ref import bernoulli_ref, bits_ref, randint_ref

_SOURCE = Path(__file__).parent / "csrc" / "threefry.cu"
NVCC_FLAGS = (*_build.BASE_FLAGS, "-Xptxas", "-v", *_build.LIBRARY_FLAGS)

_lib = None
_PTR, _I64 = ctypes.c_void_p, ctypes.c_longlong


def build() -> Path:
    """Build ``threefry.cu`` unless built; returns the library's path."""
    return _build.build(_SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        # keys, rows, n, then each entry's own arguments, out, stream.
        lib.threefry_bits.argtypes = [_PTR, _I64, _I64, _I64, ctypes.c_int,
                                      _PTR, _PTR]
        lib.threefry_bernoulli.argtypes = [_PTR, _I64, _I64, ctypes.c_float,
                                           _PTR, _PTR]
        lib.threefry_randint.argtypes = [_PTR, _I64, _I64, _PTR, _I64, _PTR,
                                         _PTR]
        for fn in (lib.threefry_bits, lib.threefry_bernoulli,
                   lib.threefry_randint):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_keys(keys: torch.Tensor, n: int) -> bool:
    """Validate ``keys`` and ``n``; True when they lie on the CPU."""
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be (R, 2), got {tuple(keys.shape)}")
    if keys.dtype != torch.int64:
        raise TypeError(f"keys must be int64, got {keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if n < 0:
        raise ValueError(f"n must be ≥ 0, got {n}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"threefry runs on cuda or cpu, not {keys.device}")
    return keys.device.type == "cpu"


def _launch(entry: str, keys: torch.Tensor, *args) -> None:
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = getattr(_library(), entry)(keys.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def threefry_bits(keys: torch.Tensor, n: int, offset: int = 0,
                  pair: bool = False) -> torch.Tensor:
    """Counters ``offset .. offset + n − 1`` under every key row:
    ``(R, n, 2)`` word pairs with ``pair`` (``split``'s new keys),
    ``(R, n)`` draws w0 ^ w1 without (``random_bits``); int64."""
    if _check_keys(keys, n):
        return bits_ref(keys, n, offset, pair)
    rows = keys.shape[0]
    out = torch.empty((rows, n, 2) if pair else (rows, n),
                      dtype=torch.int64, device=keys.device)
    _launch("threefry_bits", keys, rows, n, int(offset), int(pair),
            out.data_ptr())
    threefry_bits.launches += 1
    return out


def threefry_bernoulli(keys: torch.Tensor, n: int, p: float
                       ) -> torch.Tensor:
    """``(R, n)`` bool keep mask: uniform < float32(p)."""
    if _check_keys(keys, n):
        return bernoulli_ref(keys, n, p)
    rows = keys.shape[0]
    out = torch.empty((rows, n), dtype=torch.bool, device=keys.device)
    _launch("threefry_bernoulli", keys, rows, n, float(np.float32(p)),
            out.data_ptr())
    threefry_bernoulli.launches += 1
    return out


def threefry_randint(keys: torch.Tensor, n: int, maxval: torch.Tensor,
                     minval: int = 0) -> torch.Tensor:
    """``(R, n)`` int64 in [minval, maxval[r]), ``jax.random.randint``'s
    int32 draw; ``maxval`` ``(R,)`` int64 on the keys' device, each below
    2^31 (a span ≤ 0 gives ``minval``)."""
    cpu = _check_keys(keys, n)
    if maxval.shape != (keys.shape[0],) or maxval.dtype != torch.int64:
        raise ValueError(f"maxval must be ({keys.shape[0]},) int64, got "
                         f"{tuple(maxval.shape)} {maxval.dtype}")
    if maxval.device != keys.device:
        raise ValueError(f"maxval is on {maxval.device}, keys on "
                         f"{keys.device}")
    if cpu:
        return randint_ref(keys, n, maxval, minval)
    rows = keys.shape[0]
    maxval = maxval.contiguous()
    out = torch.empty((rows, n), dtype=torch.int64, device=keys.device)
    _launch("threefry_randint", keys, rows, n, maxval.data_ptr(),
            int(minval), out.data_ptr())
    threefry_randint.launches += 1
    return out


threefry_bits.launches = 0
threefry_bernoulli.launches = 0
threefry_randint.launches = 0
