"""Shared layers of the model zoo (the JAX package's ``models/layers.py``).

Parameters follow the reference's shapes: a dense weight is (n_in, n_out)
and applies as ``x @ w``. Parameters and activations are in the config's
dtype (bf16 at full width); normalisation statistics and RoPE angles are
fp32. Inits walk the reference's key tree: a module's
``reset_parameters(key)`` splits its threefry key (``core/prng.py``) as
the reference's ``*_init`` does, and each weight is ``jax.random.normal``
under its key in fp32, times its scale (one fp32 product), cast to the
weight's dtype, drawn in blocks of rows on the key's device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import prng


def torch_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal_init(p: torch.Tensor, key: torch.Tensor, scale: float) -> None:
    """Fill ``p`` with the reference's ``(jax.random.normal(key, p.shape,
    float32) * scale).astype(p.dtype)``: the scale rounded to fp32, one
    fp32 product, then the cast. ``key`` lies on ``p``'s device."""
    s = float(np.float32(scale))
    rows = p.detach().view(-1, p.shape[-1])
    with torch.no_grad():
        for r0, r1, draw in prng.normal_blocks(key, p.shape):
            rows[r0:r1].copy_(draw * s)


def dense_init(p: torch.Tensor, key: torch.Tensor,
               scale: float | None = None) -> None:
    """A (n_in, n_out) weight at scale 1/√n_in unless given."""
    normal_init(p, key, scale if scale is not None
                else 1.0 / np.sqrt(p.shape[0]))


def embedding_init(p: torch.Tensor, key: torch.Tensor) -> None:
    """A (vocab, d) table at scale 1/√d."""
    normal_init(p, key, 1.0 / np.sqrt(p.shape[1]))


def param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ------------------------------------------------------------- norms ------
class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype, device=None):
        super().__init__()
        self.scale = param(d, dtype=dtype, device=device)

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p.scale.float()).to(x.dtype)


# ------------------------------------------------------------- RoPE -------
def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Rotates
    the two halves of hd (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)
    angles = positions[..., None].float() * freqs        # (..., S, hd/2)
    angles = angles[..., None, :]                        # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor,
                theta: float) -> torch.Tensor:
    """M-RoPE (Qwen2-VL): hd splits into (temporal, height, width)
    sections of hd/2, hd/4 and hd/4, each rotated by its own position
    track as a RoPE of its own width (so each section has its own
    frequencies). x: (B, S, H, hd); positions_3d: (3, B, S)."""
    hd = x.shape[-1]
    sec = (hd // 2, hd // 4, hd - hd // 2 - hd // 4)
    parts, off = [], 0
    for i, s in enumerate(sec):
        parts.append(apply_rope(x[..., off:off + s], positions_3d[i], theta))
        off += s
    return torch.cat(parts, dim=-1)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Text tokens take the same index on all three M-RoPE tracks."""
    return torch.stack([positions] * 3, dim=0)


def sinusoidal_positions(seq: int, d: int) -> torch.Tensor:
    """The encoder's fixed (seq, d) table, [sin | cos] of pos / 10000^(2i/d),
    computed in float64 and returned in fp32, as the reference's."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / d)
    emb = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(emb.astype(np.float32))


# ------------------------------------------------------------- MLP --------
class MLP(nn.Module):
    """``w_in``/``w_out`` and, for SwiGLU (``act="silu"``), ``w_gate``."""

    def __init__(self, d: int, ff: int, act: str, *, dtype, device=None):
        super().__init__()
        self.act = act
        self.w_in = param(d, ff, dtype=dtype, device=device)
        self.w_out = param(ff, d, dtype=dtype, device=device)
        if act == "silu":
            self.w_gate = param(d, ff, dtype=dtype, device=device)

    def reset_parameters(self, key: torch.Tensor) -> None:
        """The reference's ``mlp_init``: ``split(key, 3)`` for ``w_in``,
        ``w_out`` and ``w_gate``."""
        ks = prng.split(key, 3)
        dense_init(self.w_in, ks[0])
        dense_init(self.w_out, ks[1])
        if self.act == "silu":
            dense_init(self.w_gate, ks[2])


def mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p.w_in
    if act == "silu":
        h = F.silu(x @ p.w_gate) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return h @ p.w_out
