"""Offline stand-ins for MNIST / CIFAR-10 (numpy copy of
``repro/data/synthetic_images.py``; same seed, same arrays).

Each class gets a smooth random prototype image; samples are prototype +
noise + a random translation — a learnable 10-class problem with
MNIST/CIFAR shapes whose class structure makes the pathological non-IID
split (2 labels per client) meaningfully heterogeneous.
"""
from __future__ import annotations

import numpy as np


def _smooth_noise(rng: np.random.Generator, shape, smooth: int = 3):
    """Low-frequency random field: random normal blurred by a box filter."""
    x = rng.normal(size=shape).astype(np.float32)
    for axis in range(2):  # blur H and W only
        for _ in range(smooth):
            x = 0.5 * x + 0.25 * (np.roll(x, 1, axis=axis)
                                  + np.roll(x, -1, axis=axis))
    return x


def make_image_dataset(
    n_samples: int,
    *,
    shape: tuple[int, int, int] = (28, 28, 1),   # MNIST-like; (32,32,3) CIFAR
    n_classes: int = 10,
    noise: float = 0.45,
    max_shift: int = 2,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images (N,H,W,C) float32, labels (N,) int32)."""
    rng = np.random.default_rng(seed)
    h, w, c = shape
    protos = np.stack(
        [_smooth_noise(rng, (h, w, c)) for _ in range(n_classes)])
    protos = (protos - protos.min()) / (np.ptp(protos) + 1e-8)

    labels = rng.integers(0, n_classes, size=n_samples).astype(np.int32)
    imgs = protos[labels].copy()
    imgs += noise * rng.normal(size=imgs.shape).astype(np.float32)
    if max_shift > 0:
        sh = rng.integers(-max_shift, max_shift + 1, size=(n_samples, 2))
        for i in range(n_samples):
            imgs[i] = np.roll(imgs[i], sh[i, 0], axis=0)
            imgs[i] = np.roll(imgs[i], sh[i, 1], axis=1)
    imgs = np.clip(imgs, -1.0, 2.0).astype(np.float32)
    return imgs, labels


def make_mnist_like(n_samples: int = 12_000, seed: int = 0):
    return make_image_dataset(n_samples, shape=(28, 28, 1), seed=seed)


def make_cifar_like(n_samples: int = 12_000, seed: int = 0):
    return make_image_dataset(n_samples, shape=(32, 32, 3), noise=0.6,
                              seed=seed)
