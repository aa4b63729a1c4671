"""Plain PyTorch versions of the RG-LRU scan kernels.

Forward: h_t = a_t ⊙ h_{t−1} + b_t over (B, S, D), carry 0 at t = 0.
Backward: the adjoint recurrence in reverse time, g_t = dh_t +
a_{t+1} ⊙ g_{t+1} from g_{S−1} = dh_{S−1}, then db_t = g_t and da_t =
g_t ⊙ h_{t−1} (da_0 = g_0 ⊙ 0). Each is the same sequential loop over t
as its kernel, one multiply and one add per step, each rounded (the
kernels are built with ``-fmad=false``), so each pair agrees to the last
bit on the card.
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


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, h (the forward's output), dh: (B, S, D) → (da, db): the
    gradients of Σ dh ⊙ h with respect to a and b."""
    da, db = torch.empty_like(a), torch.empty_like(a)
    s = a.shape[1]
    zero = torch.zeros_like(a[:, 0])
    g = dh[:, s - 1]
    for t in range(s - 1, -1, -1):
        if t < s - 1:
            g = dh[:, t] + a[:, t + 1] * g
        db[:, t] = g
        da[:, t] = g * (h[:, t - 1] if t > 0 else zero)
    return da, db
