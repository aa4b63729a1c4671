"""Offline data pipeline: synthetic images, Synthetic(α, β) and the
federated partitioners."""
from .loader import FederatedData, build_federated  # noqa: F401
from .loader import build_federated_from_pairs  # noqa: F401
from .partition import client_label_histograms, dirichlet_split  # noqa: F401
from .partition import label_skew_weights, padded_label_histograms  # noqa: F401
from .partition import pathological_split  # noqa: F401
from .synthetic_images import make_cifar_like, make_mnist_like  # noqa: F401
from .synthetic_images import make_image_dataset  # noqa: F401
from .synthetic_lr import make_synthetic_lr  # noqa: F401
