"""Wrapper of the flash-decode kernel (``csrc/flash_decode.cu``).

``flash_decode(q, k, v, length, window=None)`` is single-token GQA
attention against a KV cache: q (B, H, hd), k/v (B, S, K, hd) in fp32 or
bf16, length (B,) int32. A CUDA tensor launches the kernel or raises;
only tensors on the CPU take the plain version in :mod:`.ref`.
``flash_decode.launches`` counts calls that launched the kernel (a split
pass and a combine pass). The kernel is built at first use by
:func:`..._build.build`; its keys per split block and shared memory are
the source's, read through :func:`keys_per_block` and
:func:`smem_bytes`.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import _build, is_dtensor, local_call, refuse_grad
from .ref import flash_decode_ref

_SOURCE = Path(__file__).parent / "csrc" / "flash_decode.cu"
NVCC_FLAGS = (*_build.BASE_FLAGS, "-Xptxas", "-v", *_build.LIBRARY_FLAGS)
MAX_GROUP = 16        # G = H / K the kernel takes
MAX_HEAD_DIM = 256    # hd the kernel takes (a multiple of 8)

_lib = None


def build() -> Path:
    """Build ``flash_decode.cu`` unless built; returns the library's
    path."""
    return _build.build(_SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        # q, k, v, length, part_m, part_l, part_acc, out; batch, seq,
        # heads, kv_heads, head_dim, window; scale; bf16; stream.
        lib.flash_decode.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_decode.restype = ctypes.c_int
        lib.flash_decode_keys_per_block.argtypes = []
        lib.flash_decode_keys_per_block.restype = ctypes.c_int
        lib.flash_decode_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.flash_decode_smem_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def keys_per_block() -> int:
    """C, the keys each split block takes, as the built source has it."""
    return _library().flash_decode_keys_per_block()


def smem_bytes(head_dim: int, elem: int) -> int:
    """Dynamic shared memory of one split block at this hd and element
    size, as the built source computes it."""
    return _library().flash_decode_smem_bytes(head_dim, elem)


def _check(q, k, v, length, window) -> None:
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be (B, H, hd) and k (B, S, K, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, h, hd = q.shape
    _, s, kvh, hd_k = k.shape
    if v.shape != k.shape:
        raise ValueError(f"v has shape {tuple(v.shape)}, k "
                         f"{tuple(k.shape)}")
    if k.shape[0] != b or hd_k != hd or min(b, s, kvh) < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         f"not match")
    if h % kvh or not 1 <= h // kvh <= MAX_GROUP:
        raise ValueError(f"H = {h} must be a multiple of K = {kvh} with "
                         f"H/K ≤ {MAX_GROUP}")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"hd = {hd} must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    if tuple(length.shape) != (b,) or length.dtype != torch.int32:
        raise ValueError(f"length must be ({b},) int32, got "
                         f"{tuple(length.shape)} {length.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("length", length)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or ≥ 1, got {window}")


def flash_decode(q, k, v, length, *, window: int | None = None):
    """Attention of each query head of q (B, H, hd) over the valid keys of
    its KV head in k/v (B, S, K, hd): key t of batch b is valid when
    t < length[b] and, with a window, t ≥ length[b] − window. Returns
    (B, H, hd) in q's dtype."""
    if is_dtensor(q):
        return local_call(
            lambda *t: flash_decode(*t, window=window), (q, k, v, length),
            keep={0}, out_shapes=(q.shape,))
    if q.device.type == "meta":
        return torch.ops.repro_torch.flash_decode(q, k, v, length,
                                                  window or 0)
    _check(q, k, v, length, window)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, length, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not "
                         f"{q.device}")
    refuse_grad("flash_decode", q=q, k=k, v=v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if b * kvh > 65535:
        raise ValueError(f"B·K = {b * kvh} exceeds the grid's 65535 rows")
    rows = -(-s // keys_per_block()) * b * h
    part = torch.empty(rows * (hd + 2), dtype=torch.float32, device=q.device)
    part_acc, part_m, part_l = part.split((rows * hd, rows, rows))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library().flash_decode(
            *(t.data_ptr() for t in (q, k, v, length, part_m, part_l,
                                     part_acc, out)),
            b, s, h, kvh, hd, window or 0, 1.0 / math.sqrt(hd),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=())
def _flash_decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor, window: int) -> torch.Tensor:
    """:func:`flash_decode` as an op (``window`` 0: none), for shapes
    only: meta tensors reach it."""
    return flash_decode(q, k, v, length, window=window or None)


@_flash_decode_op.register_fake
def _(q, k, v, length, window):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, hd) and k, v (B, S, K, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return torch.empty_like(q)
