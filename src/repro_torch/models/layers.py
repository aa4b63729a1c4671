"""Shared layers of the model zoo (the JAX package's ``models/layers.py``).

Parameters follow the reference's shapes: a dense weight is (n_in, n_out)
and applies as ``x @ w``. Parameters and activations are in the config's
dtype (bf16 at full width); normalisation statistics and RoPE angles are
fp32. Inits draw fp32 normals on CPU ``torch.Generator``s (so a seed
gives the same weights on every device) and cast, as the reference draws
fp32 and casts: the layers ask :class:`NormalDraws` for their weights,
and ``LM.init`` draws them all at once, in blocks on threads.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def torch_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class NormalDraws:
    """The seeded N(0, scale²) draws of a model's weights. Layers
    :meth:`add` their requests; :meth:`run` cuts each into blocks of at
    most ``BLOCK`` values along its first axis, draws every block in fp32
    on its own CPU generator, seeded by (seed, request, block), on a pool
    of threads, scales it and copies it into its rows (cast to the
    weight's dtype). The weights depend on the seed and the order of the
    requests only, not on the device or the number of threads."""

    BLOCK = 1 << 22

    def __init__(self, seed: int):
        self.seed = seed
        self.requests: list[tuple[torch.Tensor, float]] = []

    def add(self, p: torch.Tensor, scale: float) -> None:
        """Ask for ``p`` (at least 1-D) filled with N(0, scale²)."""
        self.requests.append((p, float(scale)))

    def _blocks(self):
        for i, (p, scale) in enumerate(self.requests):
            step = max(1, self.BLOCK // max(1, p[0].numel()))
            for j, r0 in enumerate(range(0, p.shape[0], step)):
                yield p, scale, slice(r0, r0 + step), (self.seed, i, j)

    @staticmethod
    def _draw(p, scale, rows, words) -> None:
        gen = torch.Generator().manual_seed(int(
            np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
            >> np.uint64(1)))
        with torch.no_grad():     # grad mode is per thread
            draw = torch.randn(p[rows].shape, generator=gen,
                               dtype=torch.float32)
            p[rows].copy_(draw.to(p.device) * scale)

    def run(self) -> None:
        with ThreadPoolExecutor(min(16, os.cpu_count() or 1)) as pool:
            for done in [pool.submit(self._draw, *b) for b in self._blocks()]:
                done.result()
        self.requests.clear()


def dense_init(p: torch.Tensor, draws: NormalDraws,
               scale: float | None = None) -> None:
    """A (n_in, n_out) weight at scale 1/√n_in unless given."""
    draws.add(p, scale if scale is not None else 1.0 / np.sqrt(p.shape[0]))


def embedding_init(p: torch.Tensor, draws: NormalDraws) -> None:
    """A (vocab, d) table at scale 1/√d."""
    draws.add(p, 1.0 / np.sqrt(p.shape[1]))


def param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ------------------------------------------------------------- norms ------
class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype, device=None):
        super().__init__()
        self.scale = param(d, dtype=dtype, device=device)

    def reset_parameters(self, draws=None) -> None:
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

    def reset_parameters(self, draws: NormalDraws) -> None:
        dense_init(self.w_in, draws)
        dense_init(self.w_out, draws)
        if self.act == "silu":
            dense_init(self.w_gate, draws)


def mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p.w_in
    if act == "silu":
        h = F.silu(x @ p.w_gate) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return h @ p.w_out
