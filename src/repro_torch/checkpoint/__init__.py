"""npz checkpoints of the port's states and the lazy plane's store (port
of ``repro/checkpoint``)."""
from .checkpoint import (  # noqa: F401
    load_client_store,
    load_pytree,
    restore_latest,
    save_client_store,
    save_pytree,
)
