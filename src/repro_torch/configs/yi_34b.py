"""Yi-34B [arXiv:2403.04652] — llama-arch GQA (56q/8kv)."""
from .base import ModelConfig, register

YI_34B = register(ModelConfig(
    arch_id="yi-34b",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    layer_pattern=("attn",),
    rope="standard",
    rope_theta=5e6,
    act="silu",
    source="arXiv:2403.04652",
))
