"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128 experts, top-8, per-expert
FFN hidden 768, GQA 32q/4kv."""
from .base import ModelConfig, MoESpec, register

QWEN3_MOE_30B_A3B = register(ModelConfig(
    arch_id="qwen3-moe-30b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,    # per-expert hidden
    vocab=151936,
    layer_pattern=("attn",),
    moe=MoESpec(n_experts=128, top_k=8, d_expert=768),
    rope="standard",
    rope_theta=1e6,
    act="silu",
    source="hf:Qwen/Qwen3-30B-A3B",
))
