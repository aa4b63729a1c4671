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
