"""Plain PyTorch version of the flash-decode kernel: single-token GQA
decode attention as one masked full softmax.

q: (B, H, hd); k/v: (B, S, K, hd); length: (B,) valid prefix; optional
sliding window (attend to positions [length − window, length)). Scores
and softmax in fp32, masked scores −1e30; the output takes q's dtype.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_decode_ref(q, k, v, length, *, window: int | None = None):
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, hd).float()
    scores = torch.einsum("bkgh,btkh->bkgt", qg, k.float()) / math.sqrt(hd)
    pos = torch.arange(s, device=q.device)[None, :]           # (1, S)
    valid = pos < length[:, None]
    if window is not None:
        valid &= pos >= (length[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", w, v.float())
    return out.reshape(b, h, hd).to(q.dtype)


def flash_decode_split_ref(q, k, v, length, *, window: int | None = None,
                           split: int):
    """The kernel's arithmetic at ``split`` keys per block, as plain tensor
    code: each chunk's max m, weights exp(s − m), their sum l and the
    weighted sum of V; then the log-sum-exp combine
    Σ_c e^{m_c − M} acc_c / max(Σ_c e^{m_c − M} l_c, 1e-30). Key t is
    valid when t < min(length, S) and, with a window, t ≥ length − window;
    positions past S score −inf, and a chunk without a valid key in a row
    that has some gives m = −1e30, l = 0, acc = 0. Used only by the tests
    and ``chip_smoke.py``."""
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    n = -(-s // split)
    pad = n * split - s
    qg = q.reshape(b, kvh, g, hd).float()
    scores = torch.einsum("bkgh,btkh->bkgt", qg, k.float()) \
        * (1.0 / math.sqrt(hd))
    pos = torch.arange(s, device=q.device)[None, :]
    valid = pos < length[:, None]
    if window is not None:
        valid &= pos >= (length[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    scores = torch.nn.functional.pad(scores, (0, pad), value=-math.inf)
    scores = scores.reshape(b, kvh, g, n, split)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    vf = vf.reshape(b, n, split, kvh, hd)
    m = scores.amax(-1)                                      # (b,k,g,n)
    p = torch.exp(scores - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bkgnt,bntkh->bkgnh", p, vf)
    chunk_valid = torch.nn.functional.pad(valid, (0, pad)).reshape(
        b, n, split).any(-1)                                 # (b, n)
    empty = (valid.any(-1)[:, None] & ~chunk_valid)[:, None, None, :]
    m = torch.where(empty, NEG_INF, m)
    l = torch.where(empty, 0.0, l)
    acc = torch.where(empty[..., None], 0.0, acc)
    top = m.amax(-1, keepdim=True)
    w = torch.exp(m - top)
    out = (w[..., None] * acc).sum(-2) \
        / torch.clamp((w * l).sum(-1), min=1e-30)[..., None]
    return out.reshape(b, h, hd).to(q.dtype)
