"""Federated partitioners (numpy copy of ``repro/data/partition.py``;
same seed, same indices).

``pathological_split`` is the paper's §5 setting: each client holds two of
the ten labels, with variable allocation sizes; ``dirichlet_split`` the
Dir(α) label skew. The label histograms and ``label_skew_weights`` give
the ``label_skew`` walk policy its per-client utilities.
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


def dirichlet_split(
    labels: np.ndarray,
    n_clients: int,
    *,
    alpha: float = 0.3,
    min_per_client: int = 8,
    seed: int = 0,
) -> list[np.ndarray]:
    """Per-client index arrays with each class spread over the clients by
    Dir(``alpha``) proportions; a client left with fewer than
    ``min_per_client`` samples is topped up with random indices."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    out = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            out[k].extend(part.tolist())
    result = []
    all_idx = np.arange(len(labels))
    for k in range(n_clients):
        arr = np.asarray(out[k], dtype=np.int64)
        if len(arr) < min_per_client:
            arr = np.concatenate(
                [arr, rng.choice(all_idx, size=min_per_client - len(arr))]
            )
        result.append(arr)
    return result


def client_label_histograms(labels: np.ndarray, parts: list[np.ndarray],
                            n_classes: int | None = None) -> np.ndarray:
    """(n_clients, C) row-normalized label histograms of a partition."""
    if n_classes is None:
        n_classes = int(labels.max()) + 1
    hist = np.zeros((len(parts), n_classes), np.float64)
    for k, idx in enumerate(parts):
        cnt = np.bincount(np.asarray(labels)[idx], minlength=n_classes)
        hist[k] = cnt / max(int(cnt.sum()), 1)
    return hist


def padded_label_histograms(y_padded: np.ndarray, n_valid: np.ndarray,
                            n_classes: int | None = None) -> np.ndarray:
    """(n, C) label histograms from the trainers' padded layout:
    ``y_padded`` (n, m) labels with only the first ``n_valid[i]`` entries
    of row i real (``DeviceData.y_train`` / ``n_train`` on the host)."""
    y = np.asarray(y_padded)
    n_valid = np.asarray(n_valid)
    if n_classes is None:
        n_classes = int(y.max()) + 1
    hist = np.zeros((y.shape[0], n_classes), np.float64)
    for k in range(y.shape[0]):
        cnt = np.bincount(y[k, : int(n_valid[k])], minlength=n_classes)
        hist[k] = cnt / max(int(cnt.sum()), 1)
    return hist


def label_skew_weights(hist: np.ndarray, *, gamma: float = 1.0
                       ) -> np.ndarray:
    """Per-client utilities for the ``label_skew`` walk policy: the mean
    inverse global propensity of a client's labels, u_i = Σ_c h_ic·q̄/q_c
    (q the fleet-average label distribution, q̄ = 1/C), so u_i = 1 for a
    client with the global mix and u_i ≫ 1 for one holding rare labels;
    raised to ``gamma``. Strictly positive."""
    h = np.asarray(hist, np.float64)
    n_classes = h.shape[1]
    q = h.mean(axis=0)
    q = np.maximum(q, 1e-12)
    u = (h * ((1.0 / n_classes) / q)[None, :]).sum(axis=1)
    u = np.maximum(u, 1e-12)
    return u ** float(gamma)


def train_test_split_indices(
    n: int, test_frac: float = 0.25, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Paper §5: local datasets split 75% / 25% train/test."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_test = max(1, int(round(n * test_frac)))
    return perm[n_test:], perm[:n_test]
