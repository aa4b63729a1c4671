"""The paper's "Synthetic" dataset (numpy copy of the eager generator of
``repro/data/synthetic_lr.py``; same seed, same arrays): the pFedMe /
FedProx procedure Synthetic(α, β) with 60 features, 10 classes and
lognormal per-client sample counts.

  for client k:
    u_k ~ N(0, α),  b_k ~ N(0, α)            (model heterogeneity)
    B_k ~ N(0, β)                              (feature-mean heterogeneity)
    v_k ~ N(B_k, 1)  per-dim feature mean
    Σ diagonal with Σ_jj = j^{-1.2}            (decaying covariance)
    W_k ~ N(u_k, 1) ∈ R^{d×C},  c_k ~ N(b_k, 1) ∈ R^C
    x ~ N(v_k, Σ);   y = argmax softmax(W_kᵀ x + c_k)
"""
from __future__ import annotations

import numpy as np


def make_synthetic_lr(
    n_clients: int = 100,
    *,
    alpha: float = 0.5,
    beta: float = 0.5,
    n_features: int = 60,
    n_classes: int = 10,
    min_samples: int = 50,
    mean_samples: float = 4.0,  # lognormal mean of per-client counts
    seed: int = 0,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Returns per-client list of (X (n_k, d) float32, y (n_k,) int32)."""
    rng = np.random.default_rng(seed)
    cov_diag = np.array(
        [(j + 1) ** (-1.2) for j in range(n_features)], dtype=np.float64
    )
    counts = (
        rng.lognormal(mean=mean_samples, sigma=1.0, size=n_clients).astype(int)
        + min_samples
    )
    return [_client_pair(rng, int(counts[k]), alpha, beta, n_features,
                         n_classes, cov_diag) for k in range(n_clients)]


def _client_pair(rng: np.random.Generator, count: int, alpha: float,
                 beta: float, n_features: int, n_classes: int,
                 cov_diag: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One client's Synthetic(α, β) draw from the shared rng."""
    u_k = rng.normal(0.0, np.sqrt(alpha))
    b_k = rng.normal(0.0, np.sqrt(alpha))
    big_b = rng.normal(0.0, np.sqrt(beta))
    v_k = rng.normal(big_b, 1.0, size=n_features)
    w_k = rng.normal(u_k, 1.0, size=(n_features, n_classes))
    c_k = rng.normal(b_k, 1.0, size=n_classes)
    x = rng.normal(
        loc=v_k[None, :], scale=np.sqrt(cov_diag)[None, :],
        size=(count, n_features),
    )
    logits = x @ w_k + c_k[None, :]
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    y = np.array([rng.choice(n_classes, p=p) for p in probs])
    return x.astype(np.float32), y.astype(np.int32)
