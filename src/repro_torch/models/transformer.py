"""Decoder-only LM of the model zoo (the JAX package's
``models/transformer.py``, without MoE, mesh or frontends).

A model is ``layer_pattern`` repeated ``pattern_repeats`` times; each
layer is a mixer (global "attn", sliding-window "local" or recurrent
"rglru") and a dense FFN, both pre-norm and residual. The layers are one
``nn.ModuleList`` of ``n_layers`` blocks: layer ``l = r·len(pattern) + gi``
is the reference's ``params["layers"][gi][r]`` (the reference stacks the
repeats of pattern index gi on a leading axis). Serving keeps one cache
entry per layer: a ``KVCache`` for attention, an ``RGLRUState`` for
RG-LRU.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from . import attention as attn_mod
from . import recurrent as rec_mod
from .layers import MLP, RMSNorm, embedding_init, mlp, param, rmsnorm, \
    torch_dtype

KINDS = ("attn", "local", "rglru")


class Block(nn.Module):
    """One layer: ``norm1``, ``mix`` and, when d_ff > 0, ``norm2`` and
    ``ffn``."""

    def __init__(self, cfg, kind: str, *, device=None):
        super().__init__()
        self.kind = kind
        dt = torch_dtype(cfg)
        self.norm1 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        if kind == "rglru":
            self.mix = rec_mod.RGLRU(cfg, device=device)
        else:
            self.mix = attn_mod.Attention(cfg, device=device)
        if cfg.d_ff > 0:
            self.norm2 = RMSNorm(cfg.d_model, dtype=dt, device=device)
            self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dt,
                           device=device)


class LM(nn.Module):
    """Decoder-only LM. Build with ``LM(cfg, device=...)`` (``cuda`` unless
    given), then ``init`` the weights from a seed (or load the
    reference's with ``convert.load_lm_reference``)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        device = resolve_device(device)
        if not set(cfg.layer_pattern) <= set(KINDS):
            raise NotImplementedError(
                f"{cfg.arch_id}: layer kinds other than {'/'.join(KINDS)} "
                f"are not in the port yet (ROADMAP Queue 1 item 8)")
        self.cfg = cfg
        self.embed = param(cfg.vocab, cfg.d_model, dtype=torch_dtype(cfg),
                           device=device)
        self.final_norm = RMSNorm(cfg.d_model, dtype=torch_dtype(cfg),
                                  device=device)
        self.layers = nn.ModuleList(
            Block(cfg, cfg.layer_pattern[l % len(cfg.layer_pattern)],
                  device=device)
            for l in range(cfg.pattern_repeats * len(cfg.layer_pattern)))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------ init --
    def init(self, seed: int = 0) -> "LM":
        """Random weights from ``seed`` at the reference's scales and
        dtypes, drawn on a CPU generator: the same weights on every
        device (not the reference's: ``jax.random.normal`` is not
        ported)."""
        gen = torch.Generator().manual_seed(seed)
        embedding_init(self.embed, gen)
        self.final_norm.reset_parameters()
        for block in self.layers:
            for m in (block.norm1, block.mix, getattr(block, "norm2", None),
                      getattr(block, "ffn", None)):
                if m is not None:
                    m.reset_parameters(gen)
        return self

    # --------------------------------------------------------- forward --
    def _ffn(self, block: Block, h: torch.Tensor) -> torch.Tensor:
        if hasattr(block, "ffn"):
            hn2 = rmsnorm(block.norm2, h, self.cfg.norm_eps)
            h = h + mlp(block.ffn, hn2, self.cfg.act)
        return h

    def _block(self, block: Block, h, positions, decode_cache=None):
        cfg = self.cfg
        hn = rmsnorm(block.norm1, h, cfg.norm_eps)
        new_cache = None
        if decode_cache is None:
            if block.kind == "rglru":
                mixed = rec_mod.rglru_block(block.mix, hn)
            else:
                mixed = attn_mod.attention(block.mix, hn, positions, cfg,
                                           kind=block.kind)
        elif block.kind == "rglru":
            mixed, new_cache = rec_mod.rglru_decode_step(block.mix, hn,
                                                         decode_cache)
        else:
            mixed, new_cache = attn_mod.decode_attention(
                block.mix, hn, decode_cache, cfg, kind=block.kind)
        return self._ffn(block, h + mixed), new_cache

    def _assemble_inputs(self, batch: dict):
        """Token embeddings (B, S, d) and positions (B, S)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        return self.embed[tokens], positions

    def apply(self, batch: dict) -> torch.Tensor:
        """Training/prefill forward → logits (B, S, vocab) fp32."""
        h, positions = self._assemble_inputs(batch)
        for block in self.layers:
            h, _ = self._block(block, h, positions)
        return self._logits(rmsnorm(self.final_norm, h, self.cfg.norm_eps))

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """Tied embedding, in fp32."""
        return h.float() @ self.embed.float().T

    # ---------------------------------------------------------- decode --
    def init_cache(self, batch: int, max_len: int) -> dict:
        layers = []
        for kind in (block.kind for block in self.layers):
            if kind == "rglru":
                layers.append(rec_mod.rglru_init_state(self.cfg, batch,
                                                       self.device))
            else:
                layers.append(attn_mod.init_kv_cache(
                    self.cfg, batch, max_len, kind, device=self.device))
        return {"step": 0, "layers": layers}

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int):
        """Serving prefill: full forward that also fills the caches.
        Returns (logits (B, S, vocab) fp32, cache ready for
        ``decode_step``)."""
        cfg = self.cfg
        h, positions = self._assemble_inputs(batch)
        cache = self.init_cache(h.shape[0], max_len)
        new_layers = []
        for block, layer_cache in zip(self.layers, cache["layers"]):
            hn = rmsnorm(block.norm1, h, cfg.norm_eps)
            if block.kind == "rglru":
                mixed, nc = rec_mod.rglru_block(block.mix, hn,
                                                return_state=True)
            else:
                mixed, nc = attn_mod.prefill_attention(
                    block.mix, hn, positions, layer_cache, cfg,
                    kind=block.kind)
            h = self._ffn(block, h + mixed)
            new_layers.append(nc)
        logits = self._logits(rmsnorm(self.final_norm, h, cfg.norm_eps))
        return logits, {"step": h.shape[1], "layers": new_layers}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens: (B, 1) → (logits (B, vocab) fp32, cache). Attention
        layers write their KV caches in place."""
        h = self.embed[tokens]
        new_layers = []
        for block, layer_cache in zip(self.layers, cache["layers"]):
            h, nc = self._block(block, h, None, decode_cache=layer_cache)
            new_layers.append(nc)
        h = rmsnorm(self.final_norm, h, self.cfg.norm_eps)
        return self._logits(h)[:, 0], {"step": cache["step"] + 1,
                                       "layers": new_layers}
