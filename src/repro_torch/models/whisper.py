"""Whisper-style encoder-decoder (the JAX package's ``models/whisper.py``).

The mel-spectrogram and conv2 frontend is a stub: the encoder takes
precomputed frame embeddings (B, encoder_seq, d). The encoder
(bidirectional attention, fixed sinusoidal positions) and the decoder
(causal self-attention with a learned position table ``dec_pos``,
cross-attention over the encoder's output, an FFN) are real.

Parameter names mirror the reference's tree, its stacked layers
unstacked: ``enc_layers.{l}.attn.wq``, ``dec_layers.{l}.xattn.wk``,
``dec_pos``, ``enc_norm.scale`` and so on.

Decoding keeps a ``KVCache`` a decoder layer for the self-attention and
takes the cross-attention one of two ways: ``init_cache(...,
project=True)`` projects each layer's cross K/V once, and every step
contracts one query against them through the flash-decode kernel; with
``project=False`` the cache keeps the encoder output and each step
projects it again and attends with the plain chunked softmax (the
reference's recompute path, which its ``serve.py`` takes).
"""
from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..core import prng
from . import attention as attn_mod
from .layers import MLP, RMSNorm, embedding_init, lookup, mlp, normal_init, \
    param, rmsnorm, sinusoidal_positions, torch_dtype
from .transformer import _remat


class EncoderBlock(nn.Module):
    """``norm1``, ``attn`` (bidirectional), ``norm2``, ``ffn``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg)
        self.norm1 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.attn = attn_mod.Attention(cfg, device=device)
        self.norm2 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dt,
                       device=device)

    def forward(self, h: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        cfg = self.cfg
        hn = rmsnorm(self.norm1, h, cfg.norm_eps)
        h = h + attn_mod.attention(self.attn, hn, positions, cfg,
                                   causal=False)
        return h + mlp(self.ffn, rmsnorm(self.norm2, h, cfg.norm_eps),
                       cfg.act)


class DecoderBlock(nn.Module):
    """``norm1``/``attn`` (causal), ``norm_x``/``xattn`` (over the encoder
    output), ``norm2``/``ffn``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg)
        self.norm1 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.attn = attn_mod.Attention(cfg, device=device)
        self.norm_x = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.xattn = attn_mod.Attention(cfg, device=device)
        self.norm2 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dt,
                       device=device)

    def cross(self, h: torch.Tensor, positions: torch.Tensor,
              enc: torch.Tensor) -> torch.Tensor:
        hn = rmsnorm(self.norm_x, h, self.cfg.norm_eps)
        return h + attn_mod.attention(self.xattn, hn, positions, self.cfg,
                                      x_kv=enc, causal=False)

    def ffn_residual(self, h: torch.Tensor) -> torch.Tensor:
        return h + mlp(self.ffn, rmsnorm(self.norm2, h, self.cfg.norm_eps),
                       self.cfg.act)

    def forward(self, h: torch.Tensor, positions: torch.Tensor,
                enc: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        hn = rmsnorm(self.norm1, h, cfg.norm_eps)
        h = h + attn_mod.attention(self.attn, hn, positions, cfg,
                                   causal=True)
        return self.ffn_residual(self.cross(h, positions, enc))


class EncDecLM(nn.Module):
    """Encoder-decoder LM. Build with ``EncDecLM(cfg, device=...)``
    (``cuda`` unless given), then ``init`` the weights from a seed (or
    load the reference's with ``convert.load_encdec_reference``). Calling
    the module computes the training loss (:meth:`loss`), so
    ``functional_call`` takes gradients at any params; :meth:`apply`
    gives the logits."""

    def __init__(self, cfg, ctx=None, *, device=None):
        super().__init__()
        if cfg.encoder_layers < 1:
            raise ValueError(f"{cfg.arch_id}: an encoder-decoder needs "
                             f"encoder_layers ≥ 1")
        if cfg.moe is not None or set(cfg.layer_pattern) != {"attn"}:
            raise ValueError(f"{cfg.arch_id}: the encoder-decoder runs "
                             f"global attention and a dense FFN only")
        device = resolve_device(device)
        self.cfg = cfg
        self.ctx = ctx   # a ShardingCtx; DTensor placements carry it
        dt = torch_dtype(cfg)
        self.embed = param(cfg.vocab, cfg.d_model, dtype=dt, device=device)
        self.dec_pos = param(cfg.max_pos, cfg.d_model, dtype=dt,
                             device=device)
        self.enc_layers = nn.ModuleList(
            EncoderBlock(cfg, device=device)
            for _ in range(cfg.encoder_layers))
        self.dec_layers = nn.ModuleList(
            DecoderBlock(cfg, device=device) for _ in range(cfg.n_layers))
        self.enc_norm = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.final_norm = RMSNorm(cfg.d_model, dtype=dt, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------ init --
    def init(self, seed: int = 0) -> "EncDecLM":
        """The reference's ``model.init(PRNGKey(seed))``, drawn on the
        model's device along its key tree: ``split(key, 6)``; encoder block
        l under ``split(ks[0], encoder_layers)[l]`` split in two (attention,
        FFN), decoder block l under ``split(ks[1], n_layers)[l]`` split in
        three (self-attention, cross-attention, FFN); the embedding under
        ``ks[2]``, ``dec_pos`` at 0.02 under ``ks[3]``."""
        cfg = self.cfg
        ks = prng.split(prng.prng_key(seed, self.device), 6)
        enc = prng.split(prng.split(ks[0], cfg.encoder_layers), 2)
        dec = prng.split(prng.split(ks[1], cfg.n_layers), 3)
        for block, (k_attn, k_ffn) in zip(self.enc_layers, enc):
            block.attn.reset_parameters(k_attn)
            block.ffn.reset_parameters(k_ffn)
        for block, (k_attn, k_x, k_ffn) in zip(self.dec_layers, dec):
            block.attn.reset_parameters(k_attn)
            block.xattn.reset_parameters(k_x)
            block.ffn.reset_parameters(k_ffn)
        for m in self.modules():
            if isinstance(m, RMSNorm):
                m.reset_parameters()
        embedding_init(self.embed, ks[2])
        normal_init(self.dec_pos, ks[3], 0.02)
        return self

    # --------------------------------------------------------- encoder --
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, encoder_seq, d) stub embeddings → (B, T, d)."""
        cfg = self.cfg
        b, t, _ = frames.shape
        h = frames.to(torch_dtype(cfg))
        h = h + sinusoidal_positions(t, cfg.d_model).to(
            device=h.device, dtype=h.dtype)[None]
        positions = torch.arange(t, device=h.device).expand(b, t)
        remat = torch.is_grad_enabled()
        for block in self.enc_layers:
            h = _remat(block, h, positions) if remat else block(h, positions)
        return rmsnorm(self.enc_norm, h, cfg.norm_eps)

    # --------------------------------------------------------- decoder --
    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """The tied embedding, in fp32."""
        return h.float() @ self.embed.float().T

    def apply(self, batch: dict) -> torch.Tensor:
        """batch {frames (B, T, d), tokens (B, S)} → logits (B, S, vocab)
        fp32. With autograd on, each block runs again in backward."""
        cfg = self.cfg
        enc = self.encode(batch["frames"])
        tokens = batch["tokens"]
        b, s = tokens.shape
        h = lookup(self.embed, tokens) + self.dec_pos[:s][None].to(
            self.embed.dtype)
        positions = torch.arange(s, device=h.device).expand(b, s)
        remat = torch.is_grad_enabled()
        for block in self.dec_layers:
            h = (_remat(block, h, positions, enc) if remat
                 else block(h, positions, enc))
        return self._logits(rmsnorm(self.final_norm, h, cfg.norm_eps))

    def loss(self, batch: dict) -> torch.Tensor:
        """Next-token cross entropy, the mean over (B, S − 1) positions."""
        logits = self.apply(batch)[:, :-1]
        targets = batch["tokens"][:, 1:].long()
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, targets[..., None]).mean()

    def forward(self, batch: dict) -> torch.Tensor:
        return self.loss(batch)

    # ---------------------------------------------------------- decode --
    @torch.no_grad()
    def init_cache(self, batch: int, max_len: int, enc_out: torch.Tensor,
                   *, project: bool = False) -> dict:
        """A self-attention ``KVCache`` of ``max_len`` per decoder layer and
        the encoder output; with ``project``, each layer's cross K/V (B, T,
        K, hd), made once here (the reference's ``params=`` path)."""
        cfg = self.cfg
        cache = {"step": 0, "enc_out": enc_out,
                 "self_kv": [attn_mod.init_kv_cache(cfg, batch, max_len,
                                                    "attn", device=self.device)
                             for _ in self.dec_layers]}
        if project:
            cache["cross_kv"] = [attn_mod.cross_kv(block.xattn, enc_out, cfg)
                                 for block in self.dec_layers]
        return cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens: (B, 1) → (logits (B, vocab) fp32, cache). The
        self-attention caches are written in place."""
        cfg = self.cfg
        h = lookup(self.embed, tokens) + self.dec_pos[cache["step"]].to(
            self.embed.dtype)
        enc = cache["enc_out"]
        positions = torch.zeros(h.shape[:2], dtype=torch.int64,
                                device=h.device)
        cross = cache.get("cross_kv")
        new_kv = []
        for l, block in enumerate(self.dec_layers):
            hn = rmsnorm(block.norm1, h, cfg.norm_eps)
            mixed, kv = attn_mod.decode_attention(block.attn, hn,
                                                  cache["self_kv"][l], cfg)
            h = h + mixed
            new_kv.append(kv)
            if cross is None:
                h = block.cross(h, positions, enc)
            else:
                hn = rmsnorm(block.norm_x, h, cfg.norm_eps)
                h = h + attn_mod.cross_decode_attention(
                    block.xattn, hn, *cross[l], cfg)
            h = block.ffn_residual(h)
        h = rmsnorm(self.final_norm, h, cfg.norm_eps)
        return self._logits(h)[:, 0], dict(cache, step=cache["step"] + 1,
                                           self_kv=new_kv)
