"""Hand-written CUDA kernels, each beside its plain PyTorch version."""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, **tensors: torch.Tensor) -> None:
    """Raise where a kernel without a backward (flash decode, which no
    training path runs) would cut autograd: grad mode on and an input
    that requires grad. The CPU's plain version carries gradients, so
    only the CUDA path calls this."""
    needs = [name for name, t in tensors.items() if t.requires_grad]
    if needs and torch.is_grad_enabled():
        raise RuntimeError(
            f"{kernel} has no backward on the card, "
            f"and {', '.join(needs)} require grad: call it under "
            "torch.no_grad(), or on the CPU, whose plain version carries "
            "gradients")
