"""TinyLlama-1.1B [arXiv:2401.02385] — llama2-arch small, GQA (32q/4kv)."""
from .base import ModelConfig, register

TINYLLAMA_1_1B = register(ModelConfig(
    arch_id="tinyllama-1.1b",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    layer_pattern=("attn",),
    rope="standard",
    rope_theta=1e4,
    act="silu",
    source="arXiv:2401.02385",
))
