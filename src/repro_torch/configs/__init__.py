"""Architecture configs the port runs (a copy of the JAX package's config
system, registering only RecurrentGemma-9B)."""
from .base import ModelConfig, get_config, list_archs, register  # noqa: F401
from . import recurrentgemma_9b  # noqa: F401,E402  (registers it)
