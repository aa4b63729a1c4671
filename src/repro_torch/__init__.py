"""PyTorch/CUDA port of the RWSADMM simulator (``repro``'s layout and names).

The port runs on an NVIDIA GPU. Every entry point takes an explicit
``device``; left unset it means ``cuda``, and a host without a GPU raises
instead of quietly running on the CPU. Tests pass ``device="cpu"``, which
runs the plain PyTorch version of every kernel.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else
    ``cuda``. Raises when ``cuda`` is asked for (explicitly or by default)
    and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
