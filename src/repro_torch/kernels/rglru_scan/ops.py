"""Wrapper of the RG-LRU scan kernels (``csrc/rglru_scan.cu``).

``rglru_scan(a, b)`` computes h_t = a_t ⊙ h_{t−1} + b_t over (B, S, D)
fp32 tensors. A CUDA tensor launches a kernel or raises; only tensors on
the CPU take the plain version in :mod:`.ref`. The source holds two
kernels, both bit for bit equal to the plain loop, and :func:`plan`
picks one by shape: ``staged`` (shared-memory ring fed by bulk copies)
where D % 4 == 0 and the tensors are 16-byte aligned, as bulk copies
need, else ``loop`` (one thread per channel). ``rglru_scan.launches``
counts every launch and ``rglru_scan.launches_by_path`` each path's. The
kernels are built at first use by :func:`..._build.build`; the staged
kernel's geometry is the source's, read through
:func:`staged_geometry`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build, refuse_grad
from .ref import rglru_scan_ref

_SOURCE = Path(__file__).parent / "csrc" / "rglru_scan.cu"
# -fmad=false: a*h + b rounds as the plain loop's multiply then add.
NVCC_FLAGS = (*_build.BASE_FLAGS, "-fmad=false", "-Xptxas", "-v",
              *_build.LIBRARY_FLAGS)
PATHS = ("staged", "loop")

_lib = None


def plan(shape, aligned: bool = True) -> str:
    """The kernel that runs (B, S, D): ``staged`` where D % 4 == 0 and a,
    b are 16-byte aligned (``aligned``), else ``loop``."""
    return "staged" if shape[-1] % 4 == 0 and aligned else "loop"


def build() -> Path:
    """Build ``rglru_scan.cu`` unless built; returns the library's path."""
    return _build.build(_SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        # a, b, h; batch, seq, width; stream.
        for fn in (lib.rglru_scan_staged_launch, lib.rglru_scan_loop_launch):
            fn.argtypes = ([ctypes.c_void_p] * 3
                           + [ctypes.c_int, ctypes.c_longlong,
                              ctypes.c_longlong, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.rglru_scan_staged_geometry.argtypes = [
            ctypes.POINTER(ctypes.c_int)]
        lib.rglru_scan_staged_geometry.restype = None
        _lib = lib
    return _lib


def staged_geometry() -> tuple[int, int, int, int]:
    """The staged kernel's (channels per block, timesteps per stage,
    stages in the ring, dynamic shared-memory bytes), as the built source
    has them."""
    out = (ctypes.c_int * 4)()
    _library().rglru_scan_staged_geometry(out)
    return tuple(out)


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
    refuse_grad("rglru_scan", a=a, b=b)
    batch, seq, width = a.shape
    if batch > 65535:
        raise ValueError(f"B = {batch} exceeds the grid's 65535 rows")
    h = torch.empty_like(a)
    path = plan(a.shape, aligned=a.data_ptr() % 16 == 0
                and b.data_ptr() % 16 == 0)
    lib = _library()
    kernel = (lib.rglru_scan_staged_launch if path == "staged"
              else lib.rglru_scan_loop_launch)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = kernel(a.data_ptr(), b.data_ptr(), h.data_ptr(), batch, seq,
                     width, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan {path} kernel launch failed: CUDA "
                           f"error {err}")
    rglru_scan.launches += 1
    rglru_scan.launches_by_path[path] += 1
    return h


rglru_scan.launches = 0
rglru_scan.launches_by_path = dict.fromkeys(PATHS, 0)
