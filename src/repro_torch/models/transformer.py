"""Decoder-only LM of the model zoo (the JAX package's
``models/transformer.py``, without mesh or frontends).

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
"""
from __future__ import annotations

import torch
from torch import nn

import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from . import attention as attn_mod
from . import recurrent as rec_mod
from .moe import MoE
from .layers import MLP, NormalDraws, RMSNorm, dense_init, embedding_init, \
    mlp, param, rmsnorm, torch_dtype

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


def _remat(block: Block, h: torch.Tensor, positions: torch.Tensor
           ) -> torch.Tensor:
    """``block(h, positions)`` that keeps only its input for backward and
    runs again there (the reference's ``jax.checkpoint`` per pattern
    group). The block's parameters go through ``checkpoint`` as inputs:
    the recompute then reads the tensors this forward read (under
    ``functional_call``, the caller's), not whatever the module holds by
    the time backward runs."""
    names, tensors = zip(*block.named_parameters())

    def run(h, *tensors):
        return functional_call(block, dict(zip(names, tensors)),
                               (h, positions))

    return checkpoint(run, h, *tensors, use_reentrant=False)


class LM(nn.Module):
    """Decoder-only LM. Build with ``LM(cfg, device=...)`` (``cuda`` unless
    given), then ``init`` the weights from a seed (or load the
    reference's with ``convert.load_lm_reference``). Calling the module
    computes the training loss (:meth:`loss`), so ``functional_call``
    takes gradients at any params; :meth:`apply` gives the logits."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        device = resolve_device(device)
        if not set(cfg.layer_pattern) <= set(KINDS):
            raise NotImplementedError(
                f"{cfg.arch_id}: layer kinds other than {'/'.join(KINDS)} "
                f"are not in the port yet (ROADMAP Queue 1 item 8)")
        attention = any(k in ATTENTION for k in cfg.layer_pattern)
        if cfg.rope == "mrope" or (cfg.rope == "none" and attention):
            # rope="none" on attention layers needs the learned position
            # table; a recurrent stack is order-aware and takes none.
            raise NotImplementedError(
                f"{cfg.arch_id}: rope={cfg.rope!r} with attention is not in "
                f"the port yet (ROADMAP Queue 1 item 8)")
        self.cfg = cfg
        self.embed = param(cfg.vocab, cfg.d_model, dtype=torch_dtype(cfg),
                           device=device)
        if not cfg.tie_embeddings:
            self.head = param(cfg.d_model, cfg.vocab, dtype=torch_dtype(cfg),
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
        dtypes, drawn on CPU generators (``layers.NormalDraws``): the same
        weights on every device, but not the reference's key tree (parity
        tests load the reference's weights with
        ``convert.load_lm_reference``)."""
        draws = NormalDraws(seed)
        embedding_init(self.embed, draws)
        self.final_norm.reset_parameters()
        for block in self.layers:
            for m in (block.norm1, block.mix, getattr(block, "norm2", None),
                      getattr(block, "ffn", None)):
                if m is not None:
                    m.reset_parameters(draws)
        if not self.cfg.tie_embeddings:
            dense_init(self.head, draws)
        draws.run()
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
        """Token embeddings (B, S, d) and positions (B, S)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        return self.embed[tokens], positions

    def apply(self, batch: dict) -> torch.Tensor:
        """Training/prefill forward → logits (B, S, vocab) fp32. With
        autograd on, each block runs again in backward (:func:`_remat`)."""
        h, positions = self._assemble_inputs(batch)
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
        """Next-token cross entropy, the mean over (B, S − 1) positions.
        ``ce_impl``: "gather" (log-softmax, then the targets' entries) or
        "onehot" (logsumexp − Σ logits·onehot(targets)), the reference's
        two forms."""
        logits = self.apply(batch)[:, :-1]
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
        Returns (logits (B, S, vocab) fp32, cache ready for
        ``decode_step``)."""
        cfg = self.cfg
        h, positions = self._assemble_inputs(batch)
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
        h = self.embed[tokens]
        new_layers = []
        for block, layer_cache in zip(self.layers, cache["layers"]):
            h, nc = self._decode_block(block, h, layer_cache)
            new_layers.append(nc)
        h = rmsnorm(self.final_norm, h, self.cfg.norm_eps)
        return self._logits(h)[:, 0], {"step": cache["step"] + 1,
                                       "layers": new_layers}
