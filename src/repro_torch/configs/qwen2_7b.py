"""Qwen2-7B [arXiv:2407.10671] — dense decoder, GQA (28q/4kv), QKV bias."""
from .base import ModelConfig, register

QWEN2_7B = register(ModelConfig(
    arch_id="qwen2-7b",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    layer_pattern=("attn",),
    qkv_bias=True,
    rope="standard",
    rope_theta=1e6,
    act="silu",
    source="arXiv:2407.10671",
))
