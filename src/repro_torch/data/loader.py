"""Client datasets: stacked and padded, or made on demand (numpy copy of
``repro/data/loader.py``; same inputs, same arrays).

Per-client datasets are padded to a common width with a validity mask, so
every zone round works on fixed shapes. The lazy client plane draws a
client's rows only when the walk reaches it, through a
:class:`ClientDataFactory`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .partition import train_test_split_indices


@dataclasses.dataclass
class ClientDataset:
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def n_train(self) -> int:
        return len(self.y_train)

    @property
    def n_test(self) -> int:
        return len(self.y_test)


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

    @property
    def feature_shape(self) -> tuple[int, ...]:
        return self.x_train.shape[2:]

    def client(self, i: int) -> ClientDataset:
        mt = self.mask_train[i].astype(bool)
        me = self.mask_test[i].astype(bool)
        return ClientDataset(
            x_train=self.x_train[i][mt], y_train=self.y_train[i][mt],
            x_test=self.x_test[i][me], y_test=self.y_test[i][me])


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


# ---------------------------------------------------------------------------
# Lazy client plane: per-client dataset factories.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ClientDataFactory:
    """Deterministic on-demand source of per-client dataset rows.

    ``fetch(k)`` must be a pure function of ``k``: a client evicted from
    the bounded store and visited again gets its rows drawn anew, byte
    for byte, so the store spills only ADMM state, never data.
    ``rows(ids)`` pads every client to ``max_train`` / ``max_test`` with
    the zero fill :func:`_stack` uses, so a factory over a stacked
    :class:`FederatedData` gives its rows bit for bit."""

    n_clients: int
    max_train: int
    max_test: int
    feature_shape: tuple
    fetch: Callable[[int], tuple[np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]]

    def rows(self, ids) -> tuple[np.ndarray, ...]:
        """Stacked padded rows for ``ids`` in ``DeviceData`` column order:
        (x_train, y_train, n_train, x_test, y_test, mask_test)."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        m = len(ids)
        feat = tuple(self.feature_shape)
        xt = np.zeros((m, self.max_train) + feat, np.float32)
        yt = np.zeros((m, self.max_train), np.int32)
        nt = np.zeros((m,), np.int32)
        xe = np.zeros((m, self.max_test) + feat, np.float32)
        ye = np.zeros((m, self.max_test), np.int32)
        me = np.zeros((m, self.max_test), np.float32)
        for j, k in enumerate(ids):
            a, b, c, d = self.fetch(int(k))
            if len(b) > self.max_train or len(d) > self.max_test:
                raise ValueError(
                    f"client {int(k)}: {len(b)} train / {len(d)} test "
                    f"samples exceed the factory's declared widths "
                    f"({self.max_train}, {self.max_test})")
            xt[j, : len(b)] = a
            yt[j, : len(b)] = b
            nt[j] = len(b)
            xe[j, : len(d)] = c
            ye[j, : len(d)] = d
            me[j, : len(d)] = 1.0
        return xt, yt, nt, xe, ye, me


def factory_from_federated(fed: FederatedData) -> ClientDataFactory:
    """A stacked dataset as a lazy factory: its rows are slices of the
    dense arrays, so lazy and dense data agree by construction."""

    def fetch(k: int):
        c = fed.client(k)
        return c.x_train, c.y_train, c.x_test, c.y_test

    return ClientDataFactory(
        n_clients=fed.n_clients,
        max_train=fed.x_train.shape[1],
        max_test=fed.x_test.shape[1],
        feature_shape=fed.feature_shape,
        fetch=fetch,
    )


def minibatch(rng: np.random.Generator, fed: FederatedData, client: int,
              batch_size: int) -> tuple[np.ndarray, np.ndarray]:
    """A minibatch ξ from one client's (unpadded) training data."""
    valid = np.flatnonzero(fed.mask_train[client].astype(bool))
    take = rng.choice(valid, size=min(batch_size, len(valid)),
                      replace=len(valid) < batch_size)
    return fed.x_train[client][take], fed.y_train[client][take]


def minibatch_indices(rng: np.random.Generator, fed: FederatedData,
                      client: int, batch_size: int) -> np.ndarray:
    """Indices only, always ``batch_size`` of them (with replacement when
    the client holds fewer)."""
    valid = np.flatnonzero(fed.mask_train[client].astype(bool))
    return rng.choice(valid, size=batch_size, replace=len(valid) < batch_size)
