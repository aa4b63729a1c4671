"""Building a config's model, and input batches (the JAX package's
``models/registry.py``)."""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .layers import torch_dtype
from .transformer import LM, ShardingCtx
from .whisper import EncDecLM


def build_model(cfg, ctx: ShardingCtx | None = None, *, device=None
                ) -> LM | EncDecLM:
    """The config's model with uninitialised weights on ``device``
    (``cuda`` unless given; ``meta`` for shapes only) under ``ctx`` (None:
    no mesh): an ``EncDecLM`` when it has an encoder, else an ``LM``."""
    if cfg.encoder_layers > 0:
        return EncDecLM(cfg, ctx, device=device)
    return LM(cfg, ctx, device=device)


def batch_spec(cfg, batch: int, seq: int, kind: str = "train") -> dict:
    """Meta tensors standing for every model input (the dry-run): token
    ids (batch, seq) int32 and a stub frontend's ``patches`` (batch,
    n_patches, d) or ``frames`` (batch, encoder_seq, d) in the config's
    dtype; token ids (batch, 1) alone for ``kind="decode"``."""
    if kind == "decode":
        return {"tokens": torch.empty(batch, 1, dtype=torch.int32,
                                      device="meta")}
    out = {"tokens": torch.empty(batch, seq, dtype=torch.int32,
                                 device="meta")}
    stubs = {"vision_stub": ("patches", cfg.n_patches),
             "audio_stub": ("frames", cfg.encoder_seq)}
    if cfg.frontend in stubs:
        name, n = stubs[cfg.frontend]
        out[name] = torch.empty(batch, n, cfg.d_model,
                                dtype=torch_dtype(cfg), device="meta")
    return out


def random_batch(cfg, batch: int, seq: int, seed: int = 0,
                 kind: str = "train", device=None) -> dict:
    """Random inputs drawn as the reference draws them, from one
    ``np.random.default_rng(seed)`` in the same order, so both packages
    see the same arrays: token ids (batch, seq) for ``kind="train"``, then
    a stub frontend's N(0, 1) ``patches`` (batch, n_patches, d) or
    ``frames`` (batch, encoder_seq, d) in the config's dtype; (batch, 1)
    token ids alone for ``kind="decode"``. On ``device`` (``cuda`` unless
    given)."""
    if kind not in ("train", "decode"):
        raise ValueError(f"kind must be 'train' or 'decode', got {kind!r}")
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    shape = (batch, 1) if kind == "decode" else (batch, seq)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, shape),
                                     device=device)}
    if kind == "decode":
        return out
    stubs = {"vision_stub": ("patches", cfg.n_patches),
             "audio_stub": ("frames", cfg.encoder_seq)}
    if cfg.frontend in stubs:
        name, n = stubs[cfg.frontend]
        draw = rng.normal(size=(batch, n, cfg.d_model))
        out[name] = torch.as_tensor(draw, device=device).to(torch_dtype(cfg))
    return out
