"""Gemma3-12B [hf:google/gemma-3-1b-pt family] — 5:1 local:global sliding
window attention, 128k context. Local window 1024."""
from .base import ModelConfig, register

GEMMA3_12B = register(ModelConfig(
    arch_id="gemma3-12b",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab=262144,
    layer_pattern=("local",) * 5 + ("attn",),  # 5:1 local:global, ×8 = 48
    window=1024,
    rope="standard",
    rope_theta=1e6,
    act="gelu",
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
))
