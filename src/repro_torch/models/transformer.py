"""Decoder-only LM of the model zoo (the JAX package's
``models/transformer.py``), also the backbone of the vision stub
(Qwen2-VL: projected patch embeddings ahead of the text, M-RoPE
positions).

A model is ``layer_pattern`` repeated ``pattern_repeats`` times; each
layer is a mixer (global "attn", sliding-window "local", or recurrent
"rglru", "mlstm" or "slstm") and an FFN: a Mixture-of-Experts
(``models/moe.py``) when the config has ``moe``, else a dense one when
d_ff > 0; both pre-norm and residual. The layers are one ``nn.ModuleList`` of
``n_layers`` blocks: layer ``l = r·len(pattern) + gi`` is the
reference's ``params["layers"][gi][r]`` (the reference stacks the
repeats of pattern index gi on a leading axis). Serving keeps one cache
entry per layer: a ``KVCache`` for attention, an ``RGLRUState``,
``MLSTMState`` or ``SLSTMState`` for a recurrent layer.

Positions: RoPE by index (``rope="standard"``); M-RoPE's three tracks
(``"mrope"``: a patch at (0, row, col) on a g × g grid, g = ⌊√n_patches⌋,
a text token at its global index on all three); or, for a rope-less
attention stack, a learned table ``pos_embed`` added to the inputs.

Distribution (``ShardingCtx``): DTensor placements of the parameters and
inputs (``launch/sharding.py``) carry every layer but the MoE FFN, which
runs expert parallel over the mesh's model axis (``moe.moe_parallel``,
the reference's ``shard_map`` island). The reference's ``unroll`` exists
to correct XLA's cost count of a scanned layer stack; the port runs its
layers in a Python loop, so it has no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..core import prng
from . import attention as attn_mod
from . import recurrent as rec_mod
from .moe import MoE
from .layers import MLP, RMSNorm, dense_init, embedding_init, lookup, \
    mlp, normal_init, param, rmsnorm, torch_dtype

@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """How the model uses a mesh (None: single-device math): the mesh
    (a ``DeviceMesh``), its batch axes, its model axis, and whether MoE
    experts are stored ZeRO-3 (hidden dim over "data", gathered per
    layer)."""

    mesh: Any = None
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    zero3_moe: bool = False


#: each layer kind's mixer module
MIXERS = {"attn": attn_mod.Attention, "local": attn_mod.Attention,
          "rglru": rec_mod.RGLRU, "mlstm": rec_mod.MLSTM,
          "slstm": rec_mod.SLSTM}
KINDS = tuple(MIXERS)
ATTENTION = ("attn", "local")


class Block(nn.Module):
    """One layer: ``norm1``, ``mix`` and, with MoE or when d_ff > 0,
    ``norm2`` and ``ffn`` (an ``MoE`` or an ``MLP``). Calling it runs the
    layer without a cache (training and ``apply``)."""

    def __init__(self, cfg, kind: str, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        dt = torch_dtype(cfg)
        self.norm1 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.mix = MIXERS[kind](cfg, device=device)
        # MoE first: its configs set d_ff to the per-expert hidden size
        if cfg.moe is not None:
            self.norm2 = RMSNorm(cfg.d_model, dtype=dt, device=device)
            self.ffn = MoE(cfg, device=device)
        elif cfg.d_ff > 0:
            self.norm2 = RMSNorm(cfg.d_model, dtype=dt, device=device)
            self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dt,
                           device=device)

    def ffn_residual(self, h: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "ffn"):
            hn2 = rmsnorm(self.norm2, h, self.cfg.norm_eps)
            h = h + (self.ffn(hn2) if self.cfg.moe is not None
                     else mlp(self.ffn, hn2, self.cfg.act))
        return h

    def recurrent(self, hn: torch.Tensor, return_state: bool = False):
        """A recurrent mixer over the sequence hn (B, S, d), and its state
        after the last token when ``return_state``."""
        if self.kind == "rglru":
            return rec_mod.rglru_block(self.mix, hn, return_state)
        block = (rec_mod.mlstm_block if self.kind == "mlstm"
                 else rec_mod.slstm_block)
        return block(self.mix, hn, self.cfg, return_state=return_state)

    def forward(self, h: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        hn = rmsnorm(self.norm1, h, self.cfg.norm_eps)
        if self.kind in ATTENTION:
            mixed = attn_mod.attention(self.mix, hn, positions, self.cfg,
                                       kind=self.kind)
        else:
            mixed = self.recurrent(hn)
        return self.ffn_residual(h + mixed)


def _remat(block: nn.Module, *inputs: torch.Tensor) -> torch.Tensor:
    """``block(*inputs)`` that keeps only its inputs for backward and runs
    again there (the reference's ``jax.checkpoint`` per pattern group or
    layer). The block's parameters go through ``checkpoint`` as inputs:
    the recompute then reads the tensors this forward read (under
    ``functional_call``, the caller's), not whatever the module holds by
    the time backward runs."""
    names, tensors = zip(*block.named_parameters())
    n = len(inputs)

    def run(*args):
        return functional_call(block, dict(zip(names, args[n:])), args[:n])

    return checkpoint(run, *inputs, *tensors, use_reentrant=False)


def needs_pos_table(cfg) -> bool:
    """Learned positions only for rope-less attention stacks; a recurrent
    stack (xLSTM) is order-aware and takes none."""
    return cfg.rope == "none" and any(k in ATTENTION
                                      for k in cfg.layer_pattern)


class LM(nn.Module):
    """Decoder-only LM. Build with ``LM(cfg, device=...)`` (``cuda`` unless
    given), then ``init`` the weights from a seed (or load the
    reference's with ``convert.load_lm_reference``). Calling the module
    computes the training loss (:meth:`loss`), so ``functional_call``
    takes gradients at any params; :meth:`apply` gives the logits."""

    def __init__(self, cfg, ctx: Optional[ShardingCtx] = None, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        if not set(cfg.layer_pattern) <= set(KINDS):
            raise ValueError(f"{cfg.arch_id}: layer kinds must be among "
                             f"{'/'.join(KINDS)}, got {cfg.layer_pattern}")
        self.cfg = cfg
        dt = torch_dtype(cfg)
        self.embed = param(cfg.vocab, cfg.d_model, dtype=dt, device=device)
        if not cfg.tie_embeddings:
            self.head = param(cfg.d_model, cfg.vocab, dtype=dt, device=device)
        if cfg.frontend == "vision_stub":
            self.projector = param(cfg.d_model, cfg.d_model, dtype=dt,
                                   device=device)
        if needs_pos_table(cfg):
            self.pos_embed = param(cfg.max_pos, cfg.d_model, dtype=dt,
                                   device=device)
        self.final_norm = RMSNorm(cfg.d_model, dtype=torch_dtype(cfg),
                                  device=device)
        self.layers = nn.ModuleList(
            Block(cfg, cfg.layer_pattern[l % len(cfg.layer_pattern)],
                  device=device)
            for l in range(cfg.pattern_repeats * len(cfg.layer_pattern)))
        self.ctx = ctx
        if cfg.moe is not None:
            for block in self.layers:
                block.ffn.ctx = ctx

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------ init --
    def init(self, seed: int = 0) -> "LM":
        """The reference's ``model.init(PRNGKey(seed))``, drawn on the
        model's device along its key tree: ``split(key, 5)`` for the
        embedding, head, layers, frontend and encoder; layer ``l = r·P +
        gi`` under ``fold_in(split(k_layers, repeats)[r], gi)``, split in
        four (the mixer's key, then the FFN's); the projector and the
        position table both under the frontend's key, as the reference
        draws them. The bits are the reference's on every device; erf⁻¹
        leaves a few ulp (``core/prng.py``)."""
        cfg, n_pat = self.cfg, len(self.cfg.layer_pattern)
        k_emb, k_head, k_layers, k_front, _ = prng.split(
            prng.prng_key(seed, self.device), 5)
        embedding_init(self.embed, k_emb)
        self.final_norm.reset_parameters()
        layer_keys = prng.split(k_layers, cfg.pattern_repeats)
        block_keys = [prng.split(prng.fold_in(layer_keys, gi), 4)
                      for gi in range(n_pat)]        # (repeats, 4, 2) each
        for l, block in enumerate(self.layers):
            ks = block_keys[l % n_pat][l // n_pat]
            block.norm1.reset_parameters()
            block.mix.reset_parameters(ks[0])
            if hasattr(block, "ffn"):
                block.norm2.reset_parameters()
                block.ffn.reset_parameters(ks[1])
        if not cfg.tie_embeddings:
            dense_init(self.head, k_head)
        if hasattr(self, "projector"):
            dense_init(self.projector, k_front)
        if hasattr(self, "pos_embed"):
            normal_init(self.pos_embed, k_front, 0.02)
        return self

    # --------------------------------------------------------- forward --
    def _decode_block(self, block: Block, h, decode_cache):
        hn = rmsnorm(block.norm1, h, self.cfg.norm_eps)
        if block.kind in ATTENTION:
            mixed, new_cache = attn_mod.decode_attention(
                block.mix, hn, decode_cache, self.cfg, kind=block.kind)
        elif block.kind == "rglru":
            mixed, new_cache = rec_mod.rglru_decode_step(block.mix, hn,
                                                         decode_cache)
        else:
            step = (rec_mod.mlstm_decode_step if block.kind == "mlstm"
                    else rec_mod.slstm_decode_step)
            mixed, new_cache = step(block.mix, hn, decode_cache, self.cfg)
        return block.ffn_residual(h + mixed), new_cache

    def _assemble_inputs(self, batch: dict):
        """The inputs (B, S_total, d), their positions ((B, S_total), or
        M-RoPE's (3, B, S_total)) and the text's offset: a vision stub's
        projected patches (B, n_patches, d) come first, and S_total =
        n_patches + S."""
        cfg = self.cfg
        tokens = batch["tokens"]
        h = lookup(self.embed, tokens)
        offset = 0
        if cfg.frontend == "vision_stub":
            patches = batch["patches"].to(h.dtype) @ self.projector
            h = torch.cat([patches, h], dim=1)
            offset = patches.shape[1]
        b, s_total = h.shape[:2]
        pos = torch.arange(s_total, device=tokens.device).expand(b, s_total)
        if cfg.rope == "mrope":
            # patches at (t = 0, row, col); text at its global index on all
            # three tracks, so decode positions carry on from it
            g = max(1, int(np.sqrt(max(offset, 1))))
            vision = pos < offset
            positions = torch.stack([torch.where(vision, 0, pos),
                                     torch.where(vision, pos // g, pos),
                                     torch.where(vision, pos % g, pos)])
        else:
            positions = pos
        if needs_pos_table(cfg):
            h = h + self.pos_embed[:s_total][None].to(h.dtype)
        return h, positions, offset

    def apply(self, batch: dict) -> torch.Tensor:
        """Training/prefill forward → logits (B, S_total, vocab) fp32.
        With autograd on, each block runs again in backward
        (:func:`_remat`)."""
        h, positions, _ = self._assemble_inputs(batch)
        remat = torch.is_grad_enabled()
        for block in self.layers:
            h = _remat(block, h, positions) if remat else block(h, positions)
        return self._logits(rmsnorm(self.final_norm, h, self.cfg.norm_eps))

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """The tied embedding or the untied head, in fp32."""
        if self.cfg.tie_embeddings:
            return h.float() @ self.embed.float().T
        return h.float() @ self.head.float()

    def loss(self, batch: dict, *, ce_impl: str = "gather") -> torch.Tensor:
        """Next-token cross entropy over the text span, the mean over
        (B, S − 1) positions (a vision stub's patches are dropped by their
        offset). ``ce_impl``: "gather" (log-softmax, then the targets'
        entries) or "onehot" (logsumexp − Σ logits·onehot(targets)), the
        reference's two forms."""
        logits = self.apply(batch)
        offset = logits.shape[1] - batch["tokens"].shape[1]
        logits = logits[:, offset:-1]
        targets = batch["tokens"][:, 1:].long()
        if ce_impl == "onehot":
            lse = torch.logsumexp(logits, dim=-1)
            tgt = (logits * F.one_hot(targets, logits.shape[-1])
                   .to(logits.dtype)).sum(-1)
            return (lse - tgt).mean()
        if ce_impl != "gather":
            raise ValueError(f"ce_impl must be 'gather' or 'onehot', got "
                             f"{ce_impl!r}")
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, targets[..., None]).mean()

    def forward(self, batch: dict, *, ce_impl: str = "gather"
                ) -> torch.Tensor:
        return self.loss(batch, ce_impl=ce_impl)

    # ---------------------------------------------------------- decode --
    def init_cache(self, batch: int, max_len: int) -> dict:
        init_state = {"rglru": rec_mod.rglru_init_state,
                      "mlstm": rec_mod.mlstm_init_state,
                      "slstm": rec_mod.slstm_init_state}
        layers = []
        for kind in (block.kind for block in self.layers):
            if kind in ATTENTION:
                layers.append(attn_mod.init_kv_cache(
                    self.cfg, batch, max_len, kind, device=self.device))
            else:
                layers.append(init_state[kind](self.cfg, batch, self.device))
        return {"step": 0, "layers": layers}

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int):
        """Serving prefill: full forward that also fills the caches.
        Returns (logits (B, S_total, vocab) fp32, cache ready for
        ``decode_step`` at step S_total)."""
        cfg = self.cfg
        h, positions, _ = self._assemble_inputs(batch)
        cache = self.init_cache(h.shape[0], max_len)
        new_layers = []
        for block, layer_cache in zip(self.layers, cache["layers"]):
            hn = rmsnorm(block.norm1, h, cfg.norm_eps)
            if block.kind in ATTENTION:
                mixed, nc = attn_mod.prefill_attention(
                    block.mix, hn, positions, layer_cache, cfg,
                    kind=block.kind)
            else:
                mixed, nc = block.recurrent(hn, return_state=True)
            h = block.ffn_residual(h + mixed)
            new_layers.append(nc)
        logits = self._logits(rmsnorm(self.final_norm, h, cfg.norm_eps))
        return logits, {"step": h.shape[1], "layers": new_layers}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens: (B, 1) → (logits (B, vocab) fp32, cache). Attention
        layers write their KV caches in place."""
        h = lookup(self.embed, tokens)
        if needs_pos_table(self.cfg):
            h = h + self.pos_embed[cache["step"]].to(h.dtype)
        new_layers = []
        for block, layer_cache in zip(self.layers, cache["layers"]):
            h, nc = self._decode_block(block, h, layer_cache)
            new_layers.append(nc)
        h = rmsnorm(self.final_norm, h, self.cfg.norm_eps)
        return self._logits(h)[:, 0], {"step": cache["step"] + 1,
                                       "layers": new_layers}
