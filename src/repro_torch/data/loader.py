"""Stacked, padded federated datasets (numpy copy of the dense parts of
``repro/data/loader.py``; same inputs, same arrays).

Per-client datasets are padded to a common width with a validity mask, so
every zone round works on fixed shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .partition import train_test_split_indices


@dataclasses.dataclass
class FederatedData:
    """x_train: (n_clients, max_train, *feat)   mask_train: (n_clients, max_train)
    x_test:  (n_clients, max_test, *feat)    mask_test:  (n_clients, max_test)
    """

    x_train: np.ndarray
    y_train: np.ndarray
    mask_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    mask_test: np.ndarray

    @property
    def n_clients(self) -> int:
        return self.x_train.shape[0]


def build_federated(
    features: np.ndarray,
    labels: np.ndarray,
    client_indices: list[np.ndarray],
    *,
    test_frac: float = 0.25,
    seed: int = 0,
) -> FederatedData:
    """Split each client's allocation 75/25 (paper §5), pad and stack."""
    clients = []
    for k, idx in enumerate(client_indices):
        tr, te = train_test_split_indices(len(idx), test_frac, seed + k)
        clients.append((features[idx[tr]], labels[idx[tr]],
                        features[idx[te]], labels[idx[te]]))
    return _stack(clients)


def build_federated_from_pairs(
    per_client: list[tuple[np.ndarray, np.ndarray]],
    *,
    test_frac: float = 0.25,
    seed: int = 0,
) -> FederatedData:
    """For generators that already emit per-client data (Synthetic(α,β))."""
    clients = []
    for k, (x, y) in enumerate(per_client):
        tr, te = train_test_split_indices(len(y), test_frac, seed + k)
        clients.append((x[tr], y[tr], x[te], y[te]))
    return _stack(clients)


def _stack(clients) -> FederatedData:
    max_tr = max(len(c[1]) for c in clients)
    max_te = max(len(c[3]) for c in clients)
    feat = clients[0][0].shape[1:]
    n = len(clients)

    def alloc(m, shape, dtype):
        return np.zeros((n, m) + shape, dtype=dtype)

    xt = alloc(max_tr, feat, np.float32)
    yt = alloc(max_tr, (), np.int32)
    mt = alloc(max_tr, (), np.float32)
    xe = alloc(max_te, feat, np.float32)
    ye = alloc(max_te, (), np.int32)
    me = alloc(max_te, (), np.float32)
    for k, (a, b, c, d) in enumerate(clients):
        xt[k, : len(b)] = a
        yt[k, : len(b)] = b
        mt[k, : len(b)] = 1.0
        xe[k, : len(d)] = c
        ye[k, : len(d)] = d
        me[k, : len(d)] = 1.0
    return FederatedData(xt, yt, mt, xe, ye, me)
