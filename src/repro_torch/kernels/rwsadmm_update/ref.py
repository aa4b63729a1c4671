"""Plain PyTorch versions of the Eq. 31 updates in ``csrc/zone_update.cu``.

Mirror ``repro/kernels/rwsadmm_update/ref.py`` and do, operation for
operation, what the kernels do per element. Per client slot j:

    s' = sgn(y − x_j)
    x⁺_j = y − g_j/β + s' ⊙ (z_j − βε)/β
    z⁺_j = z_j + κβ (x⁺_j − y − ε)
    c_j  = x_j − (z_j/β + ε) ⊙ s'
    c⁺_j = x⁺_j − (z⁺_j/β + ε) ⊙ sgn(y − x⁺_j)
    y⁺   = y + (Σ_j m_j (c⁺_j − c_j)) / n        (j summed 0..Z−1 in order)

Padded slots (m_j = 0) return m·x⁺ + (1 − m)·x = x and fold zero. The
single-client update has no mask and no fold: y⁺ = y + (c⁺ − c)/n.

Two details keep them bit-comparable with the kernels on the card:

* The divisors β and n are 0-d tensors on the inputs' device. PyTorch's
  CUDA division by a Python float multiplies by the reciprocal, which is
  not the kernel's IEEE division.
* The fold is a Python loop over j, so the sum runs in the kernel's order.
"""
from __future__ import annotations

import torch


def _slot_update(x, z, y, g, kappa, beta, eps_half):
    """x⁺, z⁺ and c⁺ − c of one slot (or a stack, broadcast against y)."""
    b = torch.tensor(beta, dtype=y.dtype, device=y.device)
    beta_eps = beta * eps_half
    kb = kappa.reshape(()) * beta
    s_prev = torch.sign(y - x)
    x_new = y - g / b + s_prev * (z - beta_eps) / b
    z_new = z + kb * (x_new - y - eps_half)
    c_old = x - (z / b + eps_half) * s_prev
    c_new = x_new - (z_new / b + eps_half) * torch.sign(y - x_new)
    return x_new, z_new, c_new - c_old


def multizone_fused_update_ref(x, z, y, g, mask, kappa, *, beta: float,
                               eps_half: float, n_total: float):
    """x/z/g ``(K, Z, N)``, y ``(K, N)``, mask ``(K, Z)`` float, kappa a
    0-d or ``(1,)`` tensor. Returns ``(x⁺ (K, Z, N), z⁺ (K, Z, N),
    y⁺ (K, N))``: each walker's zone folds into its own token."""
    n = torch.tensor(n_total, dtype=y.dtype, device=y.device)
    m = mask.to(y.dtype).unsqueeze(-1)
    x_new, z_new, dc = _slot_update(x, z, y.unsqueeze(1), g, kappa, beta,
                                    eps_half)
    acc = torch.zeros_like(y)
    for j in range(x.shape[1]):
        acc = acc + m[:, j] * dc[:, j]
    return (m * x_new + (1.0 - m) * x,
            m * z_new + (1.0 - m) * z,
            y + acc / n)


def zone_fused_update_ref(x, z, y, g, mask, kappa, *, beta: float,
                          eps_half: float, n_total: float):
    """x/z/g ``(Z, N)``, y ``(N,)``, mask ``(Z,)`` float, kappa a 0-d or
    ``(1,)`` tensor. Returns ``(x⁺ (Z, N), z⁺ (Z, N), y⁺ (N,))``: the
    K = 1 case of :func:`multizone_fused_update_ref`."""
    x_new, z_new, y_new = multizone_fused_update_ref(
        x[None], z[None], y[None], g[None], mask[None], kappa, beta=beta,
        eps_half=eps_half, n_total=n_total)
    return x_new[0], z_new[0], y_new[0]


def fused_update_ref(x, z, y, g, kappa, *, beta: float, eps_half: float,
                     n_total: float):
    """One client, no mask: x/z/y/g ``(N,)``, kappa a 0-d or ``(1,)``
    tensor. Returns ``(x⁺, z⁺, y⁺)``, each ``(N,)``."""
    n = torch.tensor(n_total, dtype=y.dtype, device=y.device)
    x_new, z_new, dc = _slot_update(x, z, y, g, kappa, beta, eps_half)
    return x_new, z_new, y + dc / n
