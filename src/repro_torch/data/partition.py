"""Federated partitioners (numpy copy of the parts of
``repro/data/partition.py`` this port uses; same seed, same indices).

``pathological_split`` is the paper's §5 setting: each client holds two of
the ten labels, with variable allocation sizes.
"""
from __future__ import annotations

import numpy as np


def pathological_split(
    labels: np.ndarray,
    n_clients: int,
    *,
    labels_per_client: int = 2,
    size_variability: float = 0.5,
    seed: int = 0,
) -> list[np.ndarray]:
    """Per-client index arrays. Each client draws from exactly
    ``labels_per_client`` classes; sizes vary by up to
    ±``size_variability`` around the mean."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    by_class = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for idx in by_class:
        rng.shuffle(idx)
    ptr = [0] * n_classes

    # Label pairs assigned round-robin so every class is used about equally.
    client_labels = []
    pool = rng.permutation(
        np.tile(np.arange(n_classes),
                int(np.ceil(n_clients * labels_per_client / n_classes))))
    p = 0
    for _ in range(n_clients):
        chosen: list[int] = []
        while len(chosen) < labels_per_client:
            c = int(pool[p % len(pool)])
            p += 1
            if c not in chosen:
                chosen.append(c)
        client_labels.append(chosen)

    base = len(labels) // (n_clients * labels_per_client)
    out: list[np.ndarray] = []
    for k in range(n_clients):
        take: list[np.ndarray] = []
        for c in client_labels[k]:
            frac = 1.0 + size_variability * (rng.random() * 2.0 - 1.0)
            cnt = max(4, int(base * frac))
            avail = len(by_class[c]) - ptr[c]
            if avail < cnt:  # recycle with replacement if exhausted
                extra = rng.choice(by_class[c], size=cnt - avail)
                take.append(np.concatenate([by_class[c][ptr[c]:], extra]))
                ptr[c] = len(by_class[c])
            else:
                take.append(by_class[c][ptr[c]: ptr[c] + cnt])
                ptr[c] += cnt
        out.append(np.concatenate(take))
    return out


def train_test_split_indices(
    n: int, test_frac: float = 0.25, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Paper §5: local datasets split 75% / 25% train/test."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_test = max(1, int(round(n * test_frac)))
    return perm[n_test:], perm[:n_test]
