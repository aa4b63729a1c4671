"""Architecture configs: the port's own copy of the JAX package's
``ModelConfig`` (``hd``, ``pattern_repeats``, ``param_count()``,
``reduced()``) and its registry.

A config describes what the port's models run: global and local
attention with standard RoPE, M-RoPE (``rope="mrope"``, Qwen2-VL) or no
rotation (``rope="none"``: an attention stack then adds a learned
position table of ``max_pos`` rows, a recurrent stack takes none) and an
optional qkv bias; RG-LRU, the xLSTM's mLSTM and sLSTM; a
Mixture-of-Experts FFN (``moe``, a ``MoESpec``; it takes the place of the
dense FFN, and ``d_ff`` is then the reference's per-expert hidden size,
unused), a dense FFN or none (``d_ff = 0``); a tied embedding or an
untied head; an encoder of ``encoder_layers`` layers over
``encoder_seq`` stub frames (Whisper, ``models/whisper.py``); and the
stub frontends (``frontend``: "audio_stub" feeds frame embeddings to
the encoder, "vision_stub" puts ``n_patches`` projected patch
embeddings ahead of the text).

``param_count()`` keeps the reference's formula where it misses the
parameters built (tests pin both numbers).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int               # per-expert FFN hidden size
    capacity_factor: float = 1.25
    n_shared_experts: int = 0   # always-on experts (DeepSeek/Kimi style)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""

    # Layer mixing: the repeating unit of layer kinds; n_layers must be a
    # multiple of len(layer_pattern). Kinds: "attn" (global), "local"
    # (sliding window), "rglru" (Griffin recurrent), "mlstm", "slstm"
    # (xLSTM).
    layer_pattern: tuple[str, ...] = ("attn",)
    window: int = 4096           # sliding-window size for "local" layers

    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    rope: str = "standard"       # standard | mrope | none
    rope_theta: float = 1e4
    moe: Optional[MoESpec] = None
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"            # mlp activation: silu (SwiGLU) | gelu

    # Encoder-decoder (whisper): encoder layer count; 0 = decoder-only.
    encoder_layers: int = 0
    encoder_seq: int = 1500      # whisper: 30 s of audio → 1500 frames

    # Stub frontends: precomputed embeddings stand in for the mel/conv and
    # ViT stacks.
    frontend: Optional[str] = None   # None | "audio_stub" | "vision_stub"
    n_patches: int = 0               # VLM: stub patch embeddings per sample

    dtype: str = "bfloat16"
    max_pos: int = 32768   # learned-position table length (rope="none"
                           # attention archs only; recurrent archs skip it)

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern_repeats(self) -> int:
        if self.n_layers % len(self.layer_pattern):
            raise ValueError(f"{self.arch_id}: n_layers={self.n_layers} not "
                             f"a multiple of pattern {self.layer_pattern}")
        return self.n_layers // len(self.layer_pattern)

    # -- parameter counting (analytic; checked against init in tests) ----
    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd, h, kv = self.hd, self.n_heads, self.n_kv_heads
        per_kind: dict[str, int] = {}
        for kind in set(self.layer_pattern):
            if kind in ("attn", "local"):
                per_kind[kind] = d * h * hd + 2 * d * kv * hd + h * hd * d
                if self.qkv_bias:
                    per_kind[kind] += (h + 2 * kv) * hd
            elif kind == "rglru":
                # in-proj ×2 + conv4 + r/i gates + out proj.
                per_kind[kind] = 5 * d * d + 4 * d
            elif kind == "mlstm":
                # up ×2 (d→2d) + q/k/v (2d→2d) + gates + down (2d→d).
                per_kind[kind] = 18 * d * d + 2 * d * 2 * h
            elif kind == "slstm":
                # x-gates (d→4d) + recurrent gates (d→4d) + out proj.
                per_kind[kind] = 9 * d * d + 4 * d
            else:
                raise ValueError(kind)
        n = sum(per_kind[kind] + 2 * d  # + norms
                for kind in self.layer_pattern) * self.pattern_repeats
        if self.moe is not None:
            e = self.moe
            ffn = (e.n_experts + e.n_shared_experts) * 3 * d * e.d_expert \
                + d * e.n_experts
        elif ff > 0:
            ffn = 3 * d * ff if self.act == "silu" else 2 * d * ff
        else:
            ffn = 0
        n += self.n_layers * (ffn + (2 * d if ffn else 0))
        n += v * d  # embeddings
        if not self.tie_embeddings:
            n += v * d
        if self.rope == "none" and any(k in ("attn", "local")
                                       for k in self.layer_pattern):
            n += self.max_pos * d     # the learned position table
        if self.encoder_layers:
            enc = self.encoder_layers * (
                d * h * hd + 2 * d * kv * hd + h * hd * d
                + (3 * d * ff if self.act == "silu" else 2 * d * ff) + 4 * d)
            # and a cross-attention in every decoder layer
            n += enc + self.n_layers * (d * h * hd + 2 * d * kv * hd
                                        + h * hd * d + 2 * d)
        return int(n)

    def active_param_count(self) -> int:
        """MoE: params touched per token (6·N_active·D flops convention)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        total_ffn = (e.n_experts + e.n_shared_experts) * 3 * self.d_model \
            * e.d_expert * self.n_layers
        active_ffn = (e.top_k + e.n_shared_experts) * 3 * self.d_model \
            * e.d_expert * self.n_layers
        return int(self.param_count() - total_ffn + active_ffn)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same pattern, tiny dims, fp32. Note that it
        turns an MHA config (whisper's H = K = 20) into GQA (4 over 2)."""
        g = len(self.layer_pattern)
        d = min(self.d_model, 256)
        h = max(2, min(self.n_heads, 4))
        moe = None
        if self.moe is not None:
            # capacity_factor ≥ E/k ⇒ capacity = n_tokens ⇒ provably no
            # drops (each token hits an expert at most once), so decode
            # and a teacher-forced forward compute the same thing.
            moe = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_expert=128,
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                capacity_factor=4.0)
        return dataclasses.replace(
            self,
            arch_id=self.arch_id + "-reduced",
            n_layers=g if g >= 2 else 2,
            d_model=d,
            n_heads=h,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=d // h,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            window=min(self.window, 64),
            moe=moe,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32),
            n_patches=min(self.n_patches, 16),
            dtype="float32",
        )


# ---------------------------------------------------------------- shapes --
@dataclasses.dataclass(frozen=True)
class InputShape:
    """One input shape of the dry-run (``launch/dryrun.py``): a training
    step, a prefill or a decode step at ``global_batch`` × ``seq_len``
    (for decode, the KV caches' length)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

#: the architectures the dry-run takes to long_500k: the sub-quadratic
#: mixers (recurrent, or sliding-window attention in most layers); a full
#: attention stack and whisper's 448-token decoder are skipped there
LONG_OK = {"xlstm-350m", "recurrentgemma-9b", "gemma3-12b"}


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ModelConfig:
    try:
        return _REGISTRY[arch_id]
    except KeyError as e:
        raise ValueError(
            f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}") from e


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
