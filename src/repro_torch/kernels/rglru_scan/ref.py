"""Plain PyTorch version of the RG-LRU scan kernel.

h_t = a_t ⊙ h_{t−1} + b_t over (B, S, D), carry 0 at t = 0: the same
sequential loop over t as the kernel, one multiply and one add per step,
each rounded (the kernel is built with ``-fmad=false``), so the two agree
to the last bit on the card.
"""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, D) → h: (B, S, D)."""
    h = torch.empty_like(b)
    carry = torch.zeros_like(b[:, 0])
    for t in range(a.shape[1]):
        carry = a[:, t] * carry + b[:, t]
        h[:, t] = carry
    return h
