"""The RG-LRU recurrent block of Griffin / RecurrentGemma (the JAX
package's ``models/recurrent.py``, RG-LRU part).

h_t = a_t ⊙ h_{t−1} + b_t runs through the RG-LRU scan kernel
(``kernels/rglru_scan``): on a CUDA tensor it launches the kernel, on a
CPU tensor it takes the plain sequential loop. The recurrence and its
gates are fp32; the conv history is kept in the config's dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rglru_scan.ops import rglru_scan
from .layers import NormalDraws, dense_init, param, torch_dtype

_C_RGLRU = 8.0  # Griffin's fixed recurrence sharpness


class RGLRU(nn.Module):
    """Parameters of one RG-LRU block, named as the reference's dict."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d, dt = cfg.d_model, torch_dtype(cfg)
        kw = dict(dtype=dt, device=device)
        self.w_x = param(d, d, **kw)        # recurrence branch in-proj
        self.w_g = param(d, d, **kw)        # gate branch in-proj
        self.conv_w = param(4, d, **kw)     # depthwise causal conv taps
        self.w_rg = param(d, d, **kw)       # recurrence gate r_t
        self.w_ig = param(d, d, **kw)       # input gate i_t
        self.lam = param(d, dtype=torch.float32, device=device)
        self.w_out = param(d, d, **kw)

    def reset_parameters(self, draws: NormalDraws) -> None:
        dense_init(self.w_x, draws)
        dense_init(self.w_g, draws)
        draws.add(self.conv_w, 0.1)
        dense_init(self.w_rg, draws)
        dense_init(self.w_ig, draws)
        with torch.no_grad():
            self.lam.fill_(0.7)
        dense_init(self.w_out, draws)


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, d) fp32 recurrent state
    conv: torch.Tensor       # (B, 3, d) last conv inputs, oldest first


def rglru_init_state(cfg, batch: int, device=None) -> RGLRUState:
    d = cfg.d_model
    return RGLRUState(
        h=torch.zeros(batch, d, dtype=torch.float32, device=device),
        conv=torch.zeros(batch, 3, d, dtype=torch_dtype(cfg), device=device))


def _causal_conv4(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d), w: (4, d): out_t = Σ_k x_{t−k}·w[k], zero before 0."""
    s = x.shape[1]
    w = w.to(x.dtype)
    out = x * w[0]
    for k in range(1, 4):
        shifted = F.pad(x, (0, 0, k, 0))[:, :s]
        out = out + shifted * w[k]
    return out


def _rglru_gates(p, u: torch.Tensor):
    r = torch.sigmoid((u @ p.w_rg).float())
    i = torch.sigmoid((u @ p.w_ig).float())
    log_a = -_C_RGLRU * F.softplus(p.lam) * r               # (B, S, d) fp32
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    b = mult * i * u.float()
    return a, b


def rglru_block(p, x: torch.Tensor, return_state: bool = False):
    """Full Griffin recurrent block: (B, S, d) → (B, S, d), and the state
    after the last token when ``return_state``."""
    u_in = x @ p.w_x
    u = _causal_conv4(u_in, p.conv_w)
    gate = F.gelu((x @ p.w_g).float(), approximate="tanh")
    a, b = _rglru_gates(p, u)
    h = rglru_scan(a.contiguous(), b.contiguous())
    out = (h * gate).to(x.dtype) @ p.w_out
    if not return_state:
        return out
    s = x.shape[1]
    # Copies, so that the state does not keep the whole of h and u_in.
    conv_hist = u_in[:, max(0, s - 3):].clone()
    if s < 3:                       # short prompt: zeros before token 0
        conv_hist = F.pad(conv_hist, (0, 0, 3 - s, 0))
    return out, RGLRUState(h=h[:, -1].clone(), conv=conv_hist)


def rglru_decode_step(p, x: torch.Tensor, state: RGLRUState):
    """x: (B, 1, d), one token; O(1) state update."""
    u_in = (x @ p.w_x)[:, 0]                                  # (B, d)
    hist = torch.cat([state.conv, u_in[:, None]], dim=1)      # (B, 4, d)
    w = p.conv_w.to(u_in.dtype)
    # The history runs oldest first, so the newest input meets tap 0.
    u = torch.einsum("bkd,kd->bd", hist, w.flip(0))
    gate = F.gelu((x @ p.w_g).float(), approximate="tanh")[:, 0]
    a, b = _rglru_gates(p, u[:, None])
    h = a[:, 0] * state.h + b[:, 0]
    out = (h * gate).to(x.dtype)[:, None]
    return out @ p.w_out, RGLRUState(h=h, conv=hist[:, 1:])
