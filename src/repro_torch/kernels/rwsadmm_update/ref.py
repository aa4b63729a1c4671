"""Plain PyTorch version of the Eq. 31 masked zone update.

Mirrors ``repro/kernels/rwsadmm_update/ref.py::
rwsadmm_zone_fused_update_ref`` and does, operation for operation, what
``csrc/zone_update.cu`` does per element:

    s' = sgn(y − x_j)
    x⁺_j = y − g_j/β + s' ⊙ (z_j − βε)/β
    z⁺_j = z_j + κβ (x⁺_j − y − ε)
    c_j  = x_j − (z_j/β + ε) ⊙ s'
    c⁺_j = x⁺_j − (z⁺_j/β + ε) ⊙ sgn(y − x⁺_j)
    y⁺   = y + (Σ_j m_j (c⁺_j − c_j)) / n        (j summed 0..Z−1 in order)

Padded slots (m_j = 0) return m·x⁺ + (1 − m)·x = x and fold zero.

Two details keep it bit-comparable with the kernel on the card:

* The divisors β and n are 0-d tensors on the inputs' device. PyTorch's
  CUDA division by a Python float multiplies by the reciprocal, which is
  not the kernel's IEEE division.
* The fold is a Python loop over j, so the sum runs in the kernel's order.
"""
from __future__ import annotations

import torch


def zone_fused_update_ref(x, z, y, g, mask, kappa, *, beta: float,
                          eps_half: float, n_total: float):
    """x/z/g ``(Z, N)``, y ``(N,)``, mask ``(Z,)`` float, kappa a 0-d or
    ``(1,)`` tensor. Returns ``(x⁺ (Z, N), z⁺ (Z, N), y⁺ (N,))``."""
    b = torch.tensor(beta, dtype=y.dtype, device=y.device)
    n = torch.tensor(n_total, dtype=y.dtype, device=y.device)
    beta_eps = beta * eps_half
    kb = kappa.reshape(()) * beta
    m = mask.to(y.dtype).reshape(-1, 1)
    s_prev = torch.sign(y - x)
    x_new = y - g / b + s_prev * (z - beta_eps) / b
    z_new = z + kb * (x_new - y - eps_half)
    c_old = x - (z / b + eps_half) * s_prev
    c_new = x_new - (z_new / b + eps_half) * torch.sign(y - x_new)
    acc = torch.zeros_like(y)
    for j in range(x.shape[0]):
        acc = acc + m[j] * (c_new[j] - c_old[j])
    return (m * x_new + (1.0 - m) * x,
            m * z_new + (1.0 - m) * z,
            y + acc / n)
