"""Dynamic client connectivity graphs for the mobile-server random walk.

Dense lane of ``repro/core/graph.py``, kept as its own numpy copy: the
paper's "moderately dynamic connected graph of randomly placed nodes
where each node has at least 5 neighboring nodes", regenerated every
``regen_every`` rounds. Host-side control plane only; given the same
seed it yields the same graphs as the reference, bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClientGraph:
    """Undirected connectivity graph over ``n`` clients.

    adjacency: boolean (n, n) matrix, symmetric, zero diagonal.
    positions: (n, 2) client coordinates.
    """

    adjacency: np.ndarray
    positions: np.ndarray

    @property
    def n(self) -> int:
        return int(self.adjacency.shape[0])

    def neighborhood(self, i: int) -> np.ndarray:
        """N(i): client i plus its neighbors (paper's vertex set N(i))."""
        mask = self.adjacency[i].copy()
        mask[i] = True
        return np.flatnonzero(mask)


def adjacency_connected(adj: np.ndarray) -> bool:
    """Connectivity of a boolean adjacency matrix by frontier expansion
    (accumulated in intp: a uint8 dot would wrap at 256 neighbors)."""
    a = adj.view(np.uint8)
    seen = np.zeros(adj.shape[0], dtype=bool)
    seen[0] = True
    while True:
        new = (a @ seen.astype(np.intp) > 0) & ~seen
        if not new.any():
            return bool(seen.all())
        seen |= new


def pairwise_sq_dists(pos: np.ndarray) -> np.ndarray:
    """(n, n) squared distances with +inf diagonal, accumulated
    coordinate by coordinate with elementwise ops (the reference's
    accumulation order, so the kNN ties break identically)."""
    d2 = None
    for c in range(pos.shape[1]):
        dc = pos[:, c, None] - pos[None, :, c]
        dc *= dc
        d2 = dc if d2 is None else d2 + dc
    d2 = np.maximum(d2, 0.0)
    np.fill_diagonal(d2, np.inf)
    return d2


def knn_adjacency(d2: np.ndarray, k: int) -> np.ndarray:
    """Symmetrized k-nearest-neighbor adjacency from squared distances."""
    n = d2.shape[0]
    k = min(k, n - 1)
    adj = np.zeros((n, n), dtype=bool)
    if k > 0:
        nearest = np.argpartition(d2, k - 1, axis=1)[:, :k]
        np.put_along_axis(adj, nearest, True, axis=1)
    return adj | adj.T


def patch_connected(adj: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """Deterministically link nearest nodes across components until the
    graph is connected (Assumption 3.1 needs an irreducible chain).
    Mutates and returns ``adj``."""
    while not adjacency_connected(adj):
        comp = _component_labels(adj)
        a = np.flatnonzero(comp == comp[0])
        b = np.flatnonzero(comp != comp[0])
        sub = d2[np.ix_(a, b)]
        ia, ib = np.unravel_index(np.argmin(sub), sub.shape)
        adj[a[ia], b[ib]] = adj[b[ib], a[ia]] = True
    return adj


def random_geometric_graph(
    n: int,
    min_degree: int = 5,
    rng: np.random.Generator | None = None,
) -> ClientGraph:
    """Randomly placed clients, each linked to at least ``min_degree``
    nearest neighbors (paper App. D.2), symmetrized and patched to be
    connected."""
    rng = rng or np.random.default_rng(0)
    pos = rng.uniform(0.0, 1.0, size=(n, 2))
    d2 = pairwise_sq_dists(pos)
    adj = knn_adjacency(d2, min_degree)
    adj = patch_connected(adj, d2)
    return ClientGraph(adjacency=adj, positions=pos)


def _component_labels(adj: np.ndarray) -> np.ndarray:
    n = adj.shape[0]
    labels = -np.ones(n, dtype=int)
    cur = 0
    for s in range(n):
        if labels[s] >= 0:
            continue
        stack = [s]
        labels[s] = cur
        while stack:
            u = stack.pop()
            for v in np.flatnonzero(adj[u]):
                if labels[v] < 0:
                    labels[v] = cur
                    stack.append(int(v))
        cur += 1
    return labels


class DynamicGraph:
    """Moderately dynamic graph: regenerated every ``regen_every`` rounds
    (paper uses 10), positions re-drawn to model client mobility."""

    def __init__(self, n: int, min_degree: int = 5, regen_every: int = 10,
                 seed: int = 0):
        self.n = n
        self.min_degree = min_degree
        self.regen_every = max(1, regen_every)
        self._rng = np.random.default_rng(seed)
        self._round = 0
        self.graph = random_geometric_graph(n, min_degree, self._rng)
        self.n_regens = 0

    def current(self) -> ClientGraph:
        return self.graph

    def step(self) -> ClientGraph:
        """Advance one round; regenerate topology on schedule."""
        self._round += 1
        if self._round % self.regen_every == 0:
            self.graph = random_geometric_graph(
                self.n, self.min_degree, self._rng)
            self.n_regens += 1
        return self.graph

    def schedule(self, rounds: int, *, include_current: bool = False
                 ) -> list[ClientGraph]:
        """The next ``rounds`` graphs, consuming the generator exactly as
        ``rounds`` successive :meth:`step` calls would.
        ``include_current=True`` makes the first entry the current graph
        (the trainers' round-0 convention)."""
        graphs: list[ClientGraph] = []
        if include_current:
            graphs.append(self.current())
        while len(graphs) < rounds:
            graphs.append(self.step())
        return graphs
