"""GQA attention (the JAX package's ``models/attention.py``): prefill and
training attention, query-chunked with fp32 scores, self-attention
(causal, with the config's RoPE) or cross-attention over another
sequence (``x_kv``: no RoPE, no mask); single-token decode against a KV
cache (the whole sequence for global layers, a ring buffer of ``window``
slots for local ones); and one query token against a layer's
precomputed cross-attention K/V (Whisper's cached cross-attention).

Both decodes contract through the flash-decode kernel (``kernels/
flash_decode``): on a CUDA tensor it launches the kernel, on a CPU tensor
it takes the plain masked softmax.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..core import prng
from ..kernels.flash_decode.ops import flash_decode
from .layers import apply_mrope, apply_rope, dense_init, param, \
    reshape, text_mrope_positions, torch_dtype

NEG_INF = -1e30


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` and, with ``cfg.qkv_bias``, ``bq``,
    ``bk``, ``bv``, named and shaped as the reference's dict."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        kw = dict(dtype=torch_dtype(cfg), device=device)
        self.wq = param(d, h * hd, **kw)
        self.wk = param(d, kv * hd, **kw)
        self.wv = param(d, kv * hd, **kw)
        self.wo = param(h * hd, d, **kw)
        self.qkv_bias = cfg.qkv_bias
        if cfg.qkv_bias:
            self.bq = param(h * hd, **kw)
            self.bk = param(kv * hd, **kw)
            self.bv = param(kv * hd, **kw)

    def reset_parameters(self, key: torch.Tensor) -> None:
        """The reference's ``attn_init``: ``split(key, 4)`` for wq, wk, wv
        and wo (wo at 1/√(H·hd))."""
        ks = prng.split(key, 4)
        dense_init(self.wq, ks[0])
        dense_init(self.wk, ks[1])
        dense_init(self.wv, ks[2])
        dense_init(self.wo, ks[3], 1.0 / np.sqrt(self.wo.shape[0]))
        if self.qkv_bias:   # zeros, as the reference's
            with torch.no_grad():
                for b in (self.bq, self.bk, self.bv):
                    b.zero_()


def _project_qkv(p, x, x_kv, cfg):
    b, s, _ = x.shape
    t = x_kv.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = x @ p.wq, x_kv @ p.wk, x_kv @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (reshape(q, (b, s, h, hd)), reshape(k, (b, t, kv, hd)),
            reshape(v, (b, t, kv, hd)))


def _rope_qk(q, k, positions, cfg):
    """q and k rotated as ``cfg.rope`` says: "standard" by positions
    (B, S), "mrope" by the three tracks (3, B, S), "none" not at all."""
    if cfg.rope == "standard":
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    if cfg.rope == "mrope":
        return (apply_mrope(q, positions, cfg.rope_theta),
                apply_mrope(k, positions, cfg.rope_theta))
    if cfg.rope != "none":
        raise ValueError(f"rope must be standard, mrope or none, got "
                         f"{cfg.rope!r}")
    return q, k


def _chunked_attention(q, k, v, *, causal: bool, window: int | None,
                       chunk: int = 512):
    """q: (B, S, H, hd), k/v: (B, T, K, hd) → (B, S, H·hd). GQA by head
    grouping; queries in chunks of ``chunk``; scores and softmax fp32;
    optional sliding window of size ``window``."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / np.sqrt(hd)
    qg = reshape(q, (b, s, kvh, g, hd))
    kf, vf = k.float(), v.float()
    kpos = torch.arange(t, device=q.device)
    outs = []
    for c0 in range(0, s, chunk):
        qc = qg[:, c0:c0 + chunk].float()
        qpos = torch.arange(c0, c0 + qc.shape[1], device=q.device)
        scores = torch.einsum("bqkgh,btkh->bkgqt", qc, kf) * scale
        mask = torch.ones(qc.shape[1], t, dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        scores = torch.where(mask, scores, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bkgqt,btkh->bqkgh", w, vf).to(q.dtype))
    return reshape(torch.cat(outs, dim=1), (b, s, h * hd))


def attention(p, x, positions, cfg, *, kind: str = "attn", x_kv=None,
              causal: bool = True, chunk: int = 512):
    """Training/prefill attention. kind: "attn" (global) | "local". With
    ``x_kv`` (B, T, d), cross-attention of x over it: no RoPE and no
    causal mask, as the reference's."""
    cross = x_kv is not None
    q, k, v = _project_qkv(p, x, x_kv if cross else x, cfg)
    if not cross:
        q, k = _rope_qk(q, k, positions, cfg)
    window = cfg.window if kind == "local" else None
    out = _chunked_attention(q, k, v, causal=causal and not cross,
                             window=window, chunk=chunk)
    return out @ p.wo


# ------------------------------------------------------------ decode ------
class KVCache(NamedTuple):
    """KV cache of one attention layer. k/v: (B, S_cache, K, hd);
    ``length``: tokens written so far (the next token's position). Local
    layers keep S_cache = min(max_len, window) slots as a ring."""
    k: torch.Tensor
    v: torch.Tensor
    length: int


def init_kv_cache(cfg, batch: int, max_len: int, kind: str, dtype=None,
                  device=None) -> KVCache:
    size = min(max_len, cfg.window) if kind == "local" else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.hd)
    dt = dtype or torch_dtype(cfg)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device), length=0)


def prefill_attention(p, x, positions, cache: KVCache, cfg, *,
                      kind: str = "attn", chunk: int = 512):
    """Prefill: full-sequence attention that also fills the KV cache.

    Global layers write positions [0, T); local layers keep the last
    ``window`` tokens at their ring slots (slot = pos % window)."""
    t = x.shape[1]
    q, k, v = _project_qkv(p, x, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    window = cfg.window if kind == "local" else None
    out = _chunked_attention(q, k, v, causal=True, window=window,
                             chunk=chunk)
    size = cache.k.shape[1]
    k_c, v_c = torch.zeros_like(cache.k), torch.zeros_like(cache.v)
    if kind == "local" and t > size:
        keep = torch.arange(t - size, t, device=x.device)
        k_c[:, keep % size] = k[:, keep].to(k_c.dtype)
        v_c[:, keep % size] = v[:, keep].to(v_c.dtype)
    else:
        n = min(t, size)
        k_c[:, :n] = k[:, :n]
        v_c[:, :n] = v[:, :n]
    return out @ p.wo, KVCache(k=k_c, v=v_c, length=t)


def decode_attention(p, x, cache: KVCache, cfg, *, kind: str = "attn"):
    """One-token decode: x (B, 1, d) against the cache → (out (B, 1, d),
    cache). The new token's k/v are written into the cache's buffers in
    place (slot pos % size for a local ring, min(pos, size − 1) for a
    global layer), and the returned cache shares them.

    The kernel sees the valid prefix as ``length``: min(pos + 1, size) for
    a ring, whose full slots are all valid in any order (softmax does not
    depend on the order of its keys), and pos + 1 for a global layer."""
    b = x.shape[0]
    pos = cache.length
    q, k_new, v_new = _project_qkv(p, x, x, cfg)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.rope == "mrope":     # a text token: its index on all tracks
        positions = text_mrope_positions(positions)
    q, k_new = _rope_qk(q, k_new, positions, cfg)

    size = cache.k.shape[1]
    slot = pos % size if kind == "local" else min(pos, size - 1)
    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]
    n_valid = min(pos + 1, size) if kind == "local" else pos + 1
    length = torch.full((b,), n_valid, dtype=torch.int32, device=x.device)
    out = flash_decode(q[:, 0].contiguous(), cache.k, cache.v, length)
    out = reshape(out, (b, 1, cfg.n_heads * cfg.hd)).to(x.dtype)
    return out @ p.wo, KVCache(k=cache.k, v=cache.v, length=pos + 1)


def cross_kv(p, enc: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """A layer's cross-attention K and V (B, T, K, hd) of the encoder
    output ``enc`` (B, T, d), made once for every decode step."""
    b, t, _ = enc.shape
    k, v = enc @ p.wk, enc @ p.wv
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    shape = (b, t, cfg.n_kv_heads, cfg.hd)
    return reshape(k, shape), reshape(v, shape)


def cross_decode_attention(p, x, k, v, cfg) -> torch.Tensor:
    """One query token x (B, 1, d) against precomputed cross K/V (B, T, K,
    hd) → (B, 1, d): fp32 scores, a softmax over all T keys (none is
    masked) and P·V, as the reference's cached ``cross_attn``. The
    contraction is the flash-decode kernel's with every row's length T."""
    b = x.shape[0]
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = reshape(q, (b, cfg.n_heads, cfg.hd))
    length = torch.full((b,), k.shape[1], dtype=torch.int32,
                        device=x.device)
    out = flash_decode(q, k, v, length)
    return reshape(out, (b, 1, cfg.n_heads * cfg.hd)).to(x.dtype) @ p.wo
