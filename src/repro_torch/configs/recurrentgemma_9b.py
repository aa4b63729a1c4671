"""RecurrentGemma-9B [arXiv:2402.19427] — Griffin hybrid: RG-LRU recurrent
blocks + local sliding-window attention at 2:1 (attention every third
layer), MQA (kv=1), window 2048. 38 layers = (r,r,l)×12 + (r,r):
a 19-layer pattern repeated twice."""
from .base import ModelConfig, register

_PATTERN = (("rglru", "rglru", "local") * 6 + ("rglru",))  # len 19, ×2 = 38

RECURRENTGEMMA_9B = register(ModelConfig(
    arch_id="recurrentgemma-9b",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    layer_pattern=_PATTERN,
    window=2048,
    rope="standard",
    rope_theta=1e4,
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2402.19427",
))
