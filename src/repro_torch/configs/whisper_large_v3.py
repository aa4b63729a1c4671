"""Whisper-large-v3 [arXiv:2212.04356]: encoder-decoder; the mel + conv2
frontend is a stub (precomputed frame embeddings (B, 1500, d) feed the
encoder stack, ``models/whisper.py``)."""
from .base import ModelConfig, register

WHISPER_LARGE_V3 = register(ModelConfig(
    arch_id="whisper-large-v3",
    n_layers=32,            # decoder layers
    encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,          # MHA
    d_ff=5120,
    vocab=51866,
    layer_pattern=("attn",),
    rope="none",            # learned positional embeddings
    act="gelu",
    frontend="audio_stub",
    tie_embeddings=True,
    source="arXiv:2212.04356",
))
