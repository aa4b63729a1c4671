"""Wrapper of the RG-LRU scan kernel (``csrc/rglru_scan.cu``).

``rglru_scan(a, b)`` computes h_t = a_t ⊙ h_{t−1} + b_t over (B, S, D)
fp32 tensors. A CUDA tensor launches the kernel or raises; only tensors on
the CPU take the plain version in :mod:`.ref`. ``rglru_scan.launches``
counts kernel launches. The kernel is built at first use by
:func:`..._build.build`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import rglru_scan_ref

_SOURCE = Path(__file__).parent / "csrc" / "rglru_scan.cu"
# -fmad=false: a*h + b rounds as the plain loop's multiply then add.
NVCC_FLAGS = (*_build.BASE_FLAGS, "-fmad=false", "-Xptxas", "-v",
              *_build.LIBRARY_FLAGS)

_lib = None


def build() -> Path:
    """Build ``rglru_scan.cu`` unless built; returns the library's path."""
    return _build.build(_SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        # a, b, h; batch, seq, width; stream.
        lib.rglru_scan.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_void_p])
        lib.rglru_scan.restype = ctypes.c_int
        _lib = lib
    return _lib


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, D) fp32, contiguous, on one device → h (B, S, D) with
    h_t = a_t h_{t−1} + b_t and h_{−1} = 0."""
    if a.dim() != 3 or min(a.shape) < 1:
        raise ValueError(f"a must be (B, S, D) with B, S, D ≥ 1, "
                         f"got {tuple(a.shape)}")
    if b.shape != a.shape:
        raise ValueError(f"b has shape {tuple(b.shape)}, a "
                         f"{tuple(a.shape)}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu, not {a.device}")
    h = torch.empty_like(a)
    batch, seq, width = a.shape
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _library().rglru_scan(a.data_ptr(), b.data_ptr(),
                                    h.data_ptr(), batch, seq, width, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
