"""Wrappers of the Eq. 31 update kernels (``csrc/zone_update.cu``).

``multizone_fused_update`` (K walkers' zones), ``zone_fused_update`` (one
zone) and ``fused_update`` (one client) take flat fp32 tensors — the
port's client rows are already flat, so nothing is flattened or padded
per call. A CUDA tensor launches the kernel or raises; only tensors on
the CPU take the plain version in :mod:`.ref`. Each wrapper counts its
own kernel launches in ``<wrapper>.launches``.

The kernels are built at first use by :func:`..._build.build` (``nvcc``
into ``build/`` beside this file, loaded with ``ctypes``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import fused_update_ref, multizone_fused_update_ref, \
    zone_fused_update_ref

_SOURCE = Path(__file__).parent / "csrc" / "zone_update.cu"
# -fmad=false: keep the plain version's rounding (see the source's note).
NVCC_FLAGS = (*_build.BASE_FLAGS, "-fmad=false", *_build.LIBRARY_FLAGS)

_lib = None


def build() -> Path:
    """Build ``zone_update.cu`` (all three kernels) unless built; returns
    the shared library's path."""
    return _build.build(_SOURCE, NVCC_FLAGS)


_PTR = ctypes.c_void_p
_HP = [ctypes.c_float] * 4            # beta, beta·eps, eps, n_total


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        # x, z, y, g, mask, kappa, x_out, z_out, y_out; then the sizes.
        lib.rwsadmm_multizone_update.argtypes = (
            [_PTR] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
            + _HP + [_PTR])
        # x, z, y, g, kappa, x_out, z_out, y_out; then N.
        lib.rwsadmm_fused_update.argtypes = (
            [_PTR] * 8 + [ctypes.c_longlong] + _HP + [_PTR])
        for fn in (lib.rwsadmm_multizone_update, lib.rwsadmm_fused_update):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(tensors: dict, shapes: dict, kappa: torch.Tensor) -> None:
    """Shapes, then fp32, one device and contiguity of every input."""
    for name, shape in shapes.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape "
                             f"{tuple(tensors[name].shape)}, expected {shape}")
    if kappa.numel() != 1:
        raise ValueError(f"kappa must hold one value, got {tuple(kappa.shape)}")
    device = tensors["x"].device
    for name, t in {**tensors, "kappa": kappa}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the RWSADMM updates run on cuda or cpu, "
                         f"not {device}")


def _launch(entry: str, ins, outs, sizes, beta, eps_half, n_total) -> None:
    """Call one C entry on the inputs' current stream; raise on a CUDA
    error."""
    device = ins[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_library(), entry)(
            *(t.data_ptr() for t in (*ins, *outs)), *sizes, float(beta),
            float(beta * eps_half), float(eps_half), float(n_total), stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def multizone_fused_update(x, z, y, g, mask, kappa, *, beta: float,
                           eps_half: float, n_total: float):
    """K walkers' masked zone updates (paper Eq. 31) in one pass.

    x/z/g: ``(K, Z, N)`` fp32, each walker's stacked zone rows; y:
    ``(K, N)`` token stack; mask: ``(K, Z)`` fp32 (0 = padded slot; an
    all-zero row is an idle walker); kappa: 0-d or ``(1,)`` fp32 tensor.
    Returns new ``(x⁺, z⁺, y⁺)``; inputs are not modified.
    """
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"x must be (K, Z, N) with K, Z, N ≥ 1, "
                         f"got {tuple(x.shape)}")
    walkers, zone, n = x.shape
    _check({"x": x, "z": z, "y": y, "g": g, "mask": mask},
           {"z": (walkers, zone, n), "g": (walkers, zone, n),
            "y": (walkers, n), "mask": (walkers, zone)}, kappa)
    kw = dict(beta=beta, eps_half=eps_half, n_total=n_total)
    if x.device.type == "cpu":
        return multizone_fused_update_ref(x, z, y, g, mask, kappa, **kw)
    outs = (torch.empty_like(x), torch.empty_like(z), torch.empty_like(y))
    _launch("rwsadmm_multizone_update", (x, z, y, g, mask, kappa), outs,
            (walkers, zone, n), **kw)
    multizone_fused_update.launches += 1
    return outs


def zone_fused_update(x, z, y, g, mask, kappa, *, beta: float,
                      eps_half: float, n_total: float):
    """Masked multi-client zone update (paper Eq. 31) in one pass.

    x/z/g: ``(Z, N)`` fp32, the zone's stacked client rows; y: ``(N,)``
    token; mask: ``(Z,)`` fp32 (0 = padded slot); kappa: 0-d or ``(1,)``
    fp32 tensor. Returns new ``(x⁺, z⁺, y⁺)``; inputs are not modified.
    """
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"x must be (Z, N) with Z, N ≥ 1, "
                         f"got {tuple(x.shape)}")
    zone, n = x.shape
    _check({"x": x, "z": z, "y": y, "g": g, "mask": mask},
           {"z": (zone, n), "g": (zone, n), "y": (n,), "mask": (zone,)},
           kappa)
    kw = dict(beta=beta, eps_half=eps_half, n_total=n_total)
    if x.device.type == "cpu":
        return zone_fused_update_ref(x, z, y, g, mask, kappa, **kw)
    outs = (torch.empty_like(x), torch.empty_like(z), torch.empty_like(y))
    _launch("rwsadmm_multizone_update", (x, z, y, g, mask, kappa), outs,
            (1, zone, n), **kw)              # the K = 1 multi-zone launch
    zone_fused_update.launches += 1
    return outs


def fused_update(x, z, y, g, kappa, *, beta: float, eps_half: float,
                 n_total: float):
    """One client's x/z/y update (Eq. 10/15/14) in one pass.

    x/z/y/g: ``(N,)`` fp32; kappa: 0-d or ``(1,)`` fp32 tensor. Returns
    new ``(x⁺, z⁺, y⁺)`` with y⁺ = y + (c⁺ − c)/n; inputs are not
    modified.
    """
    if x.dim() != 1 or x.shape[0] < 1:
        raise ValueError(f"x must be (N,) with N ≥ 1, got {tuple(x.shape)}")
    n = x.shape[0]
    _check({"x": x, "z": z, "y": y, "g": g},
           {"z": (n,), "y": (n,), "g": (n,)}, kappa)
    kw = dict(beta=beta, eps_half=eps_half, n_total=n_total)
    if x.device.type == "cpu":
        return fused_update_ref(x, z, y, g, kappa, **kw)
    outs = (torch.empty_like(x), torch.empty_like(z), torch.empty_like(y))
    _launch("rwsadmm_fused_update", (x, z, y, g, kappa), outs, (n,), **kw)
    fused_update.launches += 1
    return outs


multizone_fused_update.launches = 0
zone_fused_update.launches = 0
fused_update.launches = 0
