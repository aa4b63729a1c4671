"""Wrappers of the RG-LRU scan kernels (``csrc/rglru_scan.cu``).

``rglru_scan(a, b)`` computes h_t = a_t ⊙ h_{t−1} + b_t over (B, S, D)
fp32 tensors and carries its gradient: it is the front of a
``torch.autograd.Function`` whose backward is :func:`rglru_scan_bwd`
(the adjoint recurrence in reverse time, its own kernels). A CUDA tensor
launches a kernel or raises; only tensors on the CPU take the plain
versions in :mod:`.ref`. The forward and the backward each have two
kernels, all bit for bit equal to their plain loops, and :func:`plan`
picks one by shape: ``staged`` (shared-memory ring fed by bulk copies)
where D % 4 == 0 and the tensors are 16-byte aligned, as bulk copies
need, else ``loop`` (one thread per channel). ``rglru_scan.launches``
and ``rglru_scan_bwd.launches`` count every launch, and each one's
``launches_by_path`` each path's. The kernels are built at first use by
:func:`..._build.build`; the staged kernels' geometry is the source's,
read through :func:`staged_geometry`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build, is_dtensor, local_call
from .ref import rglru_scan_bwd_ref, rglru_scan_ref

_SOURCE = Path(__file__).parent / "csrc" / "rglru_scan.cu"
# -fmad=false: a*h + b (and dh + a*g) round as the plain loops' multiply
# then add.
NVCC_FLAGS = (*_build.BASE_FLAGS, "-fmad=false", "-Xptxas", "-v",
              *_build.LIBRARY_FLAGS)
PATHS = ("staged", "loop")

_lib = None


#: the staged backward's tensor maps address rows by 32-bit coordinates
MAX_ROWS = 2**31 - 128


def plan(shape, aligned: bool = True) -> str:
    """The kernel that runs (B, S, D): ``staged`` where D % 4 == 0, the
    tensors are 16-byte aligned (``aligned``) and B·S < ``MAX_ROWS``,
    else ``loop``."""
    staged = shape[-1] % 4 == 0 and shape[0] * shape[1] < MAX_ROWS
    return "staged" if staged and aligned else "loop"


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
        # a, h, dh, da, db; batch, seq, width; stream.
        for fn in (lib.rglru_scan_bwd_staged_launch,
                   lib.rglru_scan_bwd_loop_launch):
            fn.argtypes = ([ctypes.c_void_p] * 5
                           + [ctypes.c_int, ctypes.c_longlong,
                              ctypes.c_longlong, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.rglru_scan_staged_geometry.argtypes = [
            ctypes.POINTER(ctypes.c_int)]
        lib.rglru_scan_staged_geometry.restype = None
        _lib = lib
    return _lib


def staged_geometry() -> tuple[int, int, int, int, int]:
    """The staged kernels' (channels per block, timesteps per stage,
    stages in the ring, dynamic shared-memory bytes of the forward, of the
    backward), as the built source has them."""
    out = (ctypes.c_int * 5)()
    _library().rglru_scan_staged_geometry(out)
    return tuple(out)


def _check(**tensors: torch.Tensor) -> None:
    """Raise unless each tensor is (B, S, D) fp32, contiguous, of one
    shape, on one device that the kernels or their plain versions take."""
    (first, t0), *rest = tensors.items()
    if t0.dim() != 3 or min(t0.shape) < 1:
        raise ValueError(f"{first} must be (B, S, D) with B, S, D ≥ 1, "
                         f"got {tuple(t0.shape)}")
    for name, t in rest:
        if t.shape != t0.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, {first} "
                             f"{tuple(t0.shape)}")
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in rest:
        if t.device != t0.device:
            raise ValueError(f"{name} is on {t.device}, {first} on "
                             f"{t0.device}")
    if t0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the RG-LRU scan runs on cuda or cpu, not "
                         f"{t0.device}")
    if t0.device.type == "cuda" and t0.shape[0] > 65535:
        raise ValueError(f"B = {t0.shape[0]} exceeds the grid's 65535 rows")


def _launched(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _path(*tensors: torch.Tensor) -> str:
    return plan(tensors[0].shape,
                aligned=all(t.data_ptr() % 16 == 0 for t in tensors))


def _forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    batch, seq, width = a.shape
    h = torch.empty_like(a)
    path = _path(a, b, h)
    lib = _library()
    kernel = (lib.rglru_scan_staged_launch if path == "staged"
              else lib.rglru_scan_loop_launch)
    with torch.cuda.device(a.device):
        err = kernel(a.data_ptr(), b.data_ptr(), h.data_ptr(), batch, seq,
                     width, _stream(a))
    _launched(err, f"rglru_scan {path}")
    rglru_scan.launches += 1
    rglru_scan.launches_by_path[path] += 1
    return h


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, h = ``rglru_scan(a, b)``, dh: (B, S, D) fp32, contiguous, on one
    device → (da, db), the gradients of Σ dh ⊙ h: g_t = dh_t +
    a_{t+1} g_{t+1} from g_{S−1} = dh_{S−1}, db = g, da_t = g_t h_{t−1}
    (da_0 = 0)."""
    if is_dtensor(a):
        return local_call(rglru_scan_bwd, (a, h, dh), keep={0, 2},
                          out_shapes=(a.shape, a.shape))
    if a.device.type == "meta":
        return torch.ops.repro_torch.rglru_scan_bwd(a, h, dh)
    _check(a=a, h=h, dh=dh)
    if a.device.type == "cpu":
        return rglru_scan_bwd_ref(a, h, dh)
    batch, seq, width = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    path = _path(a, h, dh, da, db)
    lib = _library()
    kernel = (lib.rglru_scan_bwd_staged_launch if path == "staged"
              else lib.rglru_scan_bwd_loop_launch)
    with torch.cuda.device(a.device):
        err = kernel(a.data_ptr(), h.data_ptr(), dh.data_ptr(),
                     da.data_ptr(), db.data_ptr(), batch, seq, width,
                     _stream(a))
    _launched(err, f"rglru_scan_bwd {path}")
    rglru_scan_bwd.launches += 1
    rglru_scan_bwd.launches_by_path[path] += 1
    return da, db


class _Scan(torch.autograd.Function):
    """The scan with its backward kernel. Saves a and the output h; a
    recompute under ``torch.utils.checkpoint`` runs the forward kernel
    again and saves its own."""

    @staticmethod
    def forward(ctx, a, b):
        h = _forward(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return rglru_scan_bwd(a, h, dh.contiguous())


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, D) fp32, contiguous, on one device → h (B, S, D) with
    h_t = a_t h_{t−1} + b_t and h_{−1} = 0; differentiable in a and b."""
    if is_dtensor(a):
        return local_call(rglru_scan, (a, b), keep={0, 2},
                          out_shapes=(a.shape,))
    if a.device.type == "meta":
        return torch.ops.repro_torch.rglru_scan(a, b)
    _check(a=a, b=b)
    return _Scan.apply(a, b)


# Shapes only (meta tensors): the scan and its backward as ops with fake
# implementations and the scan's autograd.

@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _scan_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _forward(a, b)


@_scan_op.register_fake
def _(a, b):
    return torch.empty_like(a)


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=())
def _scan_bwd_op(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    return rglru_scan_bwd(a, h, dh)


@_scan_bwd_op.register_fake
def _(a, h, dh):
    return torch.empty_like(a), torch.empty_like(a)


def _scan_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], output)


def _scan_backward(ctx, dh):
    a, h = ctx.saved_tensors
    return torch.ops.repro_torch.rglru_scan_bwd(a, h, dh.contiguous())


_scan_op.register_autograd(_scan_backward, setup_context=_scan_setup)


rglru_scan.launches = 0
rglru_scan.launches_by_path = dict.fromkeys(PATHS, 0)
rglru_scan_bwd.launches = 0
rglru_scan_bwd.launches_by_path = dict.fromkeys(PATHS, 0)
