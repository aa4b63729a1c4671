"""Wrappers of the threefry2x32 kernels (``csrc/threefry.cu``).

``threefry_bits`` hashes ``n`` counters under each key row;
``threefry_draws`` makes a round's batch indices and keep masks in one
launch. Both take ``keys`` ``(R, 2)`` int64 (uint32 words). A CUDA
tensor launches the kernel or raises; only tensors on the CPU take the
plain version in :mod:`.ref`. Each wrapper counts its own kernel launches
in ``<wrapper>.launches``; a launch recorded into a CUDA graph counts
once, its replays not at all.

The kernels are built at first use by :func:`..._build.build` (``nvcc``
into ``build/`` beside this file, loaded with ``ctypes``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from .. import _build
from .ref import MaskSpec, bits_ref, draws_ref

_SOURCE = Path(__file__).parent / "csrc" / "threefry.cu"
NVCC_FLAGS = (*_build.BASE_FLAGS, "-Xptxas", "-v", *_build.LIBRARY_FLAGS)
#: keep masks one ``threefry_draws`` launch makes (``kMaxMasks``)
MAX_MASKS = 2
#: a leaf's counters stay below this (32-bit counters and offsets)
MAX_COUNT = 2**31

_lib = None
_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def build() -> Path:
    """Build ``threefry.cu`` unless built; returns the library's path."""
    return _build.build(_SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.threefry_bits.argtypes = [_PTR, _INT, _I64, ctypes.c_ulonglong,
                                      _INT, _PTR, _PTR]
        lib.threefry_draws.argtypes = [
            _PTR, _INT, _INT, _PTR, _INT, _PTR, _INT, _I64, _INT, _PTR,
            _INT, _PTR, _PTR, _PTR, _INT, _PTR]
        for fn in (lib.threefry_bits, lib.threefry_draws):
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


def _check_table(name: str, t: torch.Tensor, keys: torch.Tensor) -> None:
    if t.dim() != 1 or t.dtype != torch.int64 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-d int64 tensor, "
                         f"got {tuple(t.shape)} {t.dtype}")
    if t.device != keys.device:
        raise ValueError(f"{name} is on {t.device}, keys on {keys.device}")
    if t.numel() == 0:
        raise ValueError(f"{name} is empty")


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


def threefry_draws(keys: torch.Tensor, *, split: int | None = None,
                   batch: int = 0, spans: torch.Tensor | None = None,
                   clients: torch.Tensor | None = None, minval: int = 0,
                   masks: tuple[MaskSpec, ...] = (), fold: bool = True):
    """A round's draws in one launch: ``(idx, masks)`` as
    :func:`.ref.draws_ref` makes them. The leaves are ``keys`` or, with
    ``split``, each row's ``split(key, split)``, fan-out-major; each draws
    ``batch`` indices in ``[minval, span)``, its span ``spans[clients[l %
    m]]`` (``spans[l % S]`` without ``clients``; ``spans`` and ``clients``
    int64 on the keys' device, ``clients`` in range), and up to two keep
    masks (:class:`.ref.MaskSpec`), each under ``fold_in(leaf, i + 1)`` or,
    without ``fold``, the leaf."""
    cpu = _check_keys(keys, batch)
    if split is not None and split < 1:
        raise ValueError(f"split must be ≥ 1, got {split}")
    masks = tuple(masks)
    if len(masks) > MAX_MASKS:
        raise ValueError(f"at most {MAX_MASKS} masks a launch, got "
                         f"{len(masks)}")
    dims = [spec.dims() for spec in masks]
    if batch >= MAX_COUNT or any(d[0] >= MAX_COUNT for d in dims):
        raise ValueError(f"a leaf draws fewer than 2^31 values (32-bit "
                         f"counters), got batch {batch}, masks "
                         f"{[d[0] for d in dims]}")
    if batch:
        if spans is None:
            raise ValueError("batch indices need spans")
        _check_table("spans", spans, keys)
    if clients is not None:
        _check_table("clients", clients, keys)
    leaves = keys.shape[0] * (split or 1)
    if leaves >= MAX_COUNT:
        raise ValueError(f"{leaves} leaves reach 2^31")
    kw = dict(split=split, batch=batch, spans=spans, clients=clients,
              minval=minval, masks=masks, fold=fold)
    if cpu:
        return draws_ref(keys, **kw)
    dev = keys.device
    idx = torch.empty((leaves, batch), dtype=torch.int64, device=dev)
    outs = tuple(torch.empty((leaves, *spec.out_shape), dtype=torch.bool,
                             device=dev) for spec in masks)
    if leaves * (batch + sum(d[0] for d in dims)) == 0:
        return idx, outs
    flat = [v for d in dims for v in d] or [0]
    _launch("threefry_draws", keys, keys.shape[0], split or 0,
            0 if spans is None else spans.data_ptr(),
            0 if spans is None else spans.shape[0],
            0 if clients is None else clients.data_ptr(),
            0 if clients is None else clients.shape[0], int(minval), batch,
            idx.data_ptr(), len(masks), (ctypes.c_int * len(flat))(*flat),
            (ctypes.c_float * MAX_MASKS)(*(float(np.float32(s.p))
                                          for s in masks)),
            (ctypes.c_void_p * MAX_MASKS)(*(o.data_ptr() for o in outs)),
            int(fold))
    threefry_draws.launches += 1
    return idx, outs


threefry_bits.launches = 0
threefry_draws.launches = 0
