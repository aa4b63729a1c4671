"""Building a config's model, and input batches (the JAX package's
``models/registry.py``)."""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .transformer import LM


def build_model(cfg, *, device=None) -> LM:
    """The config's model with uninitialised weights on ``device``
    (``cuda`` unless given)."""
    return LM(cfg, device=device)


def random_batch(cfg, batch: int, seq: int, seed: int = 0,
                 kind: str = "train", device=None) -> dict:
    """Random token ids drawn as the reference draws them
    (``np.random.default_rng(seed)``), so both packages see the same ids:
    (batch, seq) for ``kind="train"``, (batch, 1) for ``kind="decode"``,
    on ``device`` (``cuda`` unless given)."""
    if kind not in ("train", "decode"):
        raise ValueError(f"kind must be 'train' or 'decode', got {kind!r}")
    rng = np.random.default_rng(seed)
    shape = (batch, 1) if kind == "decode" else (batch, seq)
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, shape),
                                      device=resolve_device(device))}
