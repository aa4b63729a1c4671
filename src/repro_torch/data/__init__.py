"""Offline data pipeline: synthetic images + federated partitioners."""
from .loader import FederatedData, build_federated  # noqa: F401
from .partition import pathological_split  # noqa: F401
from .synthetic_images import make_image_dataset  # noqa: F401
