"""Qwen2-VL-2B [arXiv:2409.12191]: VLM backbone with M-RoPE. The ViT
vision encoder is a stub: precomputed patch embeddings (B, n_patches, d)
go through the projector ahead of the text tokens, and M-RoPE gives the
patch span (t, h, w) positions."""
from .base import ModelConfig, register

QWEN2_VL_2B = register(ModelConfig(
    arch_id="qwen2-vl-2b",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    layer_pattern=("attn",),
    qkv_bias=True,
    rope="mrope",
    rope_theta=1e6,
    act="silu",
    frontend="vision_stub",
    n_patches=256,          # one 16×16 patch grid per sample (stub)
    tie_embeddings=True,
    source="arXiv:2409.12191",
))
