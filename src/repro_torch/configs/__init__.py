"""Architecture configs the port runs (a copy of the JAX package's config
system, registering the architectures whose layers the port has)."""
from .base import INPUT_SHAPES, LONG_OK, InputShape, ModelConfig, \
    MoESpec, get_config, list_archs, register  # noqa: F401
# Importing these modules registers them.
from . import (  # noqa: F401,E402
    gemma3_12b,
    kimi_k2_1t_a32b,
    qwen2_7b,
    qwen2_vl_2b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
    tinyllama_1_1b,
    whisper_large_v3,
    xlstm_350m,
    yi_34b,
)

#: every registered architecture, in the reference's order
ALL_ARCHS = [
    "qwen2-7b",
    "xlstm-350m",
    "whisper-large-v3",
    "kimi-k2-1t-a32b",
    "tinyllama-1.1b",
    "recurrentgemma-9b",
    "gemma3-12b",
    "qwen2-vl-2b",
    "yi-34b",
    "qwen3-moe-30b-a3b",
]
