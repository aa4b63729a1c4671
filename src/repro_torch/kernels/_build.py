"""Build a kernel's CUDA source with ``nvcc`` at first use.

Each kernel package keeps its source under ``csrc/`` and builds it into a
shared library with a plain C interface under ``build/`` beside its
``ops.py`` (listed in ``.gitignore``), loaded with ``ctypes``. The library
is named by a hash of the source and the flags, so an edited source or a
changed flag rebuilds; nvcc's own output (``-Xptxas -v`` where a kernel
asks for it) is kept beside it as ``<library>.log``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

# Every kernel is built for Hopper (sm_90a) into a position-independent
# shared library; a kernel adds its own flags after these.
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3")
LIBRARY_FLAGS = ("-shared", "-Xcompiler", "-fPIC")


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
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def build(source: Path, flags: tuple[str, ...]) -> Path:
    """Compile ``source`` with ``flags`` into ``build/`` beside its
    ``csrc/`` unless that exact build exists. Returns the shared library's
    path. Raises if the build fails."""
    build_dir = source.parent.parent / "build"
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()
    out = build_dir / f"{source.stem}-{tag[:16]}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = [find_nvcc(), *flags, "-o", tmp, str(source)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}")
        Path(f"{out}.log").write_text(res.stdout + res.stderr)
        os.replace(tmp, out)   # atomic: concurrent builds race safely
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
