"""Wrapper of the Eq. 31 zone-update kernel (``csrc/zone_update.cu``).

``zone_fused_update`` takes flat ``(Z, N)`` / ``(N,)`` fp32 tensors — the
port's client rows are already flat, so nothing is flattened or padded
per call. A CUDA tensor launches the kernel or raises; only tensors on
the CPU take the plain version in :mod:`.ref`.

The kernel is built at first use with ``nvcc`` into a shared library with
a plain C interface, under ``build/`` beside this file (listed in
``.gitignore``), named by a hash of the source and flags so an edited
source rebuilds. It is loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .ref import zone_fused_update_ref

_SOURCE = Path(__file__).parent / "csrc" / "zone_update.cu"
_BUILD_DIR = Path(__file__).parent / "build"
# -fmad=false: keep the plain version's rounding (see the source's note).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, ``PATH`` or
    ``/usr/local/cuda``; raises if there is none."""
    candidates = [os.path.join(os.environ[k], "bin", "nvcc")
                  for k in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(k)]
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the zone-update "
                       "kernel is built from source at first use")


def build() -> Path:
    """Compile the kernel into ``build/`` unless that exact build exists.
    Returns the shared library's path. Raises if the build fails."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = _BUILD_DIR / f"zone_update-{tag[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)   # atomic: concurrent builds race safely
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.rwsadmm_zone_update
        fn.argtypes = ([ctypes.c_void_p] * 9
                       + [ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_float] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, z, y, g, mask, kappa):
    zone, n = x.shape if x.dim() == 2 else (None, None)
    if zone is None or zone < 1 or n < 1:
        raise ValueError(f"x must be (Z, N) with Z, N ≥ 1, got {tuple(x.shape)}")
    want = {"x": (x, (zone, n)), "z": (z, (zone, n)), "g": (g, (zone, n)),
            "y": (y, (n,)), "mask": (mask, (zone,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if kappa.numel() != 1:
        raise ValueError(f"kappa must hold one value, got {tuple(kappa.shape)}")
    for name, t in (("x", x), ("z", z), ("y", y), ("g", g),
                    ("mask", mask), ("kappa", kappa)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return zone, n


def zone_fused_update(x, z, y, g, mask, kappa, *, beta: float,
                      eps_half: float, n_total: float):
    """Masked multi-client zone update (paper Eq. 31) in one pass.

    x/z/g: ``(Z, N)`` fp32, the zone's stacked client rows; y: ``(N,)``
    token; mask: ``(Z,)`` fp32 (0 = padded slot); kappa: 0-d or ``(1,)``
    fp32 tensor. Returns new ``(x⁺, z⁺, y⁺)``; inputs are not modified.
    ``zone_fused_update.launches`` counts kernel launches.
    """
    zone, n = _check(x, z, y, g, mask, kappa)
    if x.device.type == "cpu":
        return zone_fused_update_ref(x, z, y, g, mask, kappa, beta=beta,
                                     eps_half=eps_half, n_total=n_total)
    if x.device.type != "cuda":
        raise ValueError(f"zone_fused_update runs on cuda or cpu, "
                         f"not {x.device}")
    lib = _library()
    x_out = torch.empty_like(x)
    z_out = torch.empty_like(z)
    y_out = torch.empty_like(y)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rwsadmm_zone_update(
            x.data_ptr(), z.data_ptr(), y.data_ptr(), g.data_ptr(),
            mask.data_ptr(), kappa.data_ptr(), x_out.data_ptr(),
            z_out.data_ptr(), y_out.data_ptr(), zone, n, float(beta),
            float(beta * eps_half), float(eps_half), float(n_total), stream)
    if err != 0:
        raise RuntimeError(f"zone_update kernel launch failed: CUDA error "
                           f"{err}")
    zone_fused_update.launches += 1
    return x_out, z_out, y_out


zone_fused_update.launches = 0
