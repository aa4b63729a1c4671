"""Client connectivity graphs for the mobile-server random walk.

Port of ``repro/core/graph.py``, kept as its own numpy copy: the paper's
"moderately dynamic connected graph of randomly placed nodes where each
node has at least 5 neighboring nodes", regenerated every
``regen_every`` rounds (the dense lane: ``ClientGraph``,
``DynamicGraph``), and the sparse neighbor-list lane (``NeighborGraph``)
that the scenarios' ``graph_backend="sparse"`` runs at large n.
Host-side control plane only; given the same seed every function here
yields the reference's graphs bit for bit.
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

    def degree(self, i: int | None = None):
        """deg(i), or every client's degree as an (n,) array."""
        deg = self.adjacency.sum(axis=1)
        return int(deg[i]) if i is not None else deg

    def neighborhood(self, i: int) -> np.ndarray:
        """N(i): client i plus its neighbors (paper's vertex set N(i))."""
        mask = self.adjacency[i].copy()
        mask[i] = True
        return np.flatnonzero(mask)

    def neighbors(self, i: int) -> np.ndarray:
        """N(i) \\ {i}."""
        return np.flatnonzero(self.adjacency[i])

    @property
    def n_edges(self) -> int:
        return int(self.adjacency.sum()) // 2

    def is_connected(self) -> bool:
        return adjacency_connected(self.adjacency)


def adjacency_connected(adj: np.ndarray) -> bool:
    """Connectivity of a boolean adjacency matrix.

    Vectorized frontier expansion (runs at every regeneration epoch —
    and every round under link-dropout scenarios; a Python-loop BFS
    dominates schedule precomputation at n ≳ 500). The matvec avoids
    the row-gather copy a boolean index would make each iteration;
    accumulate in intp — a uint8 dot would wrap at 256 seen neighbors
    and misreport dense graphs.
    """
    a = adj.view(np.uint8)
    seen = np.zeros(adj.shape[0], dtype=bool)
    seen[0] = True
    while True:
        new = (a @ seen.astype(np.intp) > 0) & ~seen
        if not new.any():
            return bool(seen.all())
        seen |= new


# Distance-matrix cache: producers (range_graph, the mobility models,
# the batched rollout) seed the graph they return; consumers in the same
# round (link layer, comm pricing) hit it instead of recomputing the
# O(n²) matrix. The cache lives ON the graph object (set via
# object.__setattr__ to sidestep the frozen dataclass), so any number of
# live graphs — e.g. a whole rollout window — keep their matrices
# simultaneously, and a graph's cache dies with it.
def seed_sq_dist_cache(graph: "ClientGraph", d2: np.ndarray) -> None:
    object.__setattr__(graph, "_sq_dists", d2)


def detach_rollout_views(graph: "ClientGraph") -> None:
    """Copy-on-seed (memory): a graph assembled by the batched rollout
    (:func:`graphs_from_stack`) holds *views* into its window's
    (R, n, n) adjacency and distance stacks; a caller retaining one
    graph past the chunk window (the scenario keeps the window's last
    graph as its current state) would pin both whole stacks live.
    Copying the retained graph's slices costs O(n²) once and lets the
    O(R·n²) stacks be freed — values are unchanged, so everything
    downstream stays bit-identical.
    """
    d2 = getattr(graph, "_sq_dists", None)
    if d2 is not None and d2.base is not None:
        object.__setattr__(graph, "_sq_dists", d2.copy())
    fields = (("nbrs", "nbr_mask", "nbr_d2", "positions")
              if not hasattr(graph, "adjacency")
              else ("adjacency", "positions"))
    for name in fields:
        arr = getattr(graph, name)
        if arr.base is not None:
            object.__setattr__(graph, name, arr.copy())


def graph_sq_dists(graph: "ClientGraph") -> np.ndarray:
    """Squared pairwise distances for a graph's positions (cached)."""
    d2 = getattr(graph, "_sq_dists", None)
    if d2 is None:
        d2 = pairwise_sq_dists(graph.positions)
        seed_sq_dist_cache(graph, d2)
    return d2


def _sum_sq_diffs(coord_pairs) -> np.ndarray:
    """THE distance kernel: Σ_c (a_c − b_c)², accumulated coordinate-
    by-coordinate with elementwise ops only, then clamped at 0.

    Every squared-distance producer in the repo — the dense (n, n)
    matrix, the (R, n, n) rollout batch, the sparse lane's gathered
    pairs, the cross-component patch — feeds its per-coordinate
    operand pairs through this one loop, so all of them share one
    float accumulation order *structurally*. Elementwise ops — unlike
    a BLAS matmul expansion, whose accumulation order is build-
    dependent — make the dense and sparse lanes bit-identical by
    construction.
    """
    d2 = None
    for a, b in coord_pairs:
        dc = a - b
        dc *= dc
        d2 = dc if d2 is None else d2 + dc
    return np.maximum(d2, 0.0)


def pairwise_sq_dists(pos: np.ndarray) -> np.ndarray:
    """(n, n) squared distances with +inf diagonal."""
    d2 = _sum_sq_diffs((pos[:, c, None], pos[None, :, c])
                       for c in range(pos.shape[1]))
    np.fill_diagonal(d2, np.inf)
    return d2


def pairwise_sq_dists_batch(pos: np.ndarray) -> np.ndarray:
    """(R, n, n) squared distances with +inf diagonals for a stack of
    position frames (R, n, 2) — bit-identical to R per-frame
    :func:`pairwise_sq_dists` calls."""
    d2 = _sum_sq_diffs((pos[:, :, None, c], pos[:, None, :, c])
                       for c in range(pos.shape[2]))
    idx = np.arange(pos.shape[1])
    d2[:, idx, idx] = np.inf
    return d2


def pair_sq_dists(pos: np.ndarray, i: np.ndarray, j: np.ndarray
                  ) -> np.ndarray:
    """Squared distances for gathered index pairs (i, j) — the sparse
    lane's form of :func:`pairwise_sq_dists`."""
    return _sum_sq_diffs((pos[i, c], pos[j, c])
                         for c in range(pos.shape[1]))


def adjacency_connected_batch(adj: np.ndarray) -> np.ndarray:
    """(R,) connectivity flags for a stack of adjacency matrices (R, n, n).

    One frontier expansion for the whole batch: ~graph-diameter
    iterations of a single (R, n, n) @ (R, n, 1) matmul, instead of R
    independent BFS loops — this is the hot check of the batched
    link-dropout path, which re-validates every round's surviving graph.
    """
    a = adj.view(np.uint8)
    seen = np.zeros(adj.shape[:2], dtype=bool)
    seen[:, 0] = True
    while True:
        new = (np.matmul(a, seen[..., None].astype(np.intp))[..., 0] > 0) \
            & ~seen
        if not new.any():
            return seen.all(axis=1)
        seen |= new


def graphs_from_stack(adj: np.ndarray, d2s, positions) -> "list[ClientGraph]":
    """Assemble per-round ``ClientGraph``s from a batched adjacency
    stack: one batched connectivity check, a component re-patch only
    for the rounds that need it, and each graph seeded with its
    distance matrix. The shared tail of every batched-rollout lane
    (range/kNN mobility graphs, link-dropout survivors) — change the
    patch or cache protocol here and every lane follows.

    ``d2s`` and ``positions`` are per-round indexables (stacked arrays
    or lists); ``adj`` is (R, n, n) and is patched in place.
    """
    for r in np.flatnonzero(~adjacency_connected_batch(adj)):
        patch_connected(adj[r], d2s[r])
    out = []
    for r in range(adj.shape[0]):
        g = ClientGraph(adjacency=adj[r], positions=positions[r])
        seed_sq_dist_cache(g, d2s[r])
        out.append(g)
    return out


def knn_adjacency(d2: np.ndarray, k: int) -> np.ndarray:
    """Symmetrized k-nearest-neighbor adjacency from squared distances.

    argpartition is O(n²) vs argsort's O(n² log n) — this runs at every
    regeneration epoch.
    """
    n = d2.shape[0]
    k = min(k, n - 1)
    adj = np.zeros((n, n), dtype=bool)
    if k > 0:
        nearest = np.argpartition(d2, k - 1, axis=1)[:, :k]
        np.put_along_axis(adj, nearest, True, axis=1)
    return adj | adj.T


def patch_connected(adj: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """Deterministically link nearest nodes across components until the
    graph is connected (Assumption 3.1 requires an irreducible chain).
    Mutates and returns ``adj``.
    """
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
    """Randomly placed clients; each connected to at least ``min_degree``
    nearest neighbors (paper App. D.2), then symmetrized and patched to be
    connected (Assumption 3.1 requires an irreducible chain)."""
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
    (paper uses 10). Node count and min-degree are preserved; positions are
    re-drawn, modelling client mobility between server visits."""

    def __init__(
        self,
        n: int,
        min_degree: int = 5,
        regen_every: int = 10,
        seed: int = 0,
    ):
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
                self.n, self.min_degree, self._rng
            )
            self.n_regens += 1
        return self.graph

    def schedule(self, rounds: int,
                 *, include_current: bool = False) -> list[ClientGraph]:
        """Batch variant of :meth:`step`: the next ``rounds`` graphs.

        Consumes the generator state exactly as ``rounds`` successive
        ``step()`` calls would, so an eager per-round engine and a
        precomputed-schedule engine see identical topologies (including
        regeneration epochs). ``include_current=True`` makes the first
        entry the *current* graph without advancing — the round-0
        convention of the trainers, which use ``current()`` before the
        first ``step()``.
        """
        graphs: list[ClientGraph] = []
        if include_current:
            graphs.append(self.current())
        while len(graphs) < rounds:
            graphs.append(self.step())
        return graphs


# ---------------------------------------------------------------------------
# Sparse neighbor-list backend (large n).
#
# The dense lane above materializes O(n²) adjacency/distance matrices —
# fine to a few hundred clients, memory-blocked long before the paper's
# "n mobile devices" scaling story gets interesting. The sparse lane
# stores the same graph as capped-degree neighbor lists: (n, k_cap)
# int32 ids + validity mask + aligned squared distances, O(n·k) in both
# memory and per-round control-plane work. Producers live in
# ``scenarios.mobility`` (grid-bucket neighbor search); every consumer
# (walk stepping, zone planning, link dropouts, pricing) reads lists
# through this class. Where the dense lane is RNG-free the two lanes
# give bit-identical graphs.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NeighborGraph:
    """Undirected graph over ``n`` clients as packed neighbor lists.

    nbrs:     (n, k_cap) int32 — row i's neighbors in slots
              ``[:deg(i)]``, sorted ascending; padding slots hold 0.
    nbr_mask: (n, k_cap) bool — validity per slot (packed left).
    positions:(n, 2) client coordinates.
    nbr_d2:   (n, k_cap) float64 — squared distance to each neighbor,
              aligned with ``nbrs`` (padding slots hold 0).

    Symmetric by construction: j ∈ nbrs[i] ⇔ i ∈ nbrs[j].
    """

    nbrs: np.ndarray
    nbr_mask: np.ndarray
    positions: np.ndarray
    nbr_d2: np.ndarray

    @property
    def n(self) -> int:
        return int(self.nbrs.shape[0])

    @property
    def k_cap(self) -> int:
        return int(self.nbrs.shape[1])

    def degree(self, i: int | None = None):
        """deg(i), or every client's degree as an (n,) array."""
        deg = self.nbr_mask.sum(axis=1)
        return int(deg[i]) if i is not None else deg

    def neighbors(self, i: int) -> np.ndarray:
        """N(i) \\ {i}, sorted ascending (packed-left invariant)."""
        return self.nbrs[i, : int(self.nbr_mask[i].sum())]

    def neighborhood(self, i: int) -> np.ndarray:
        """N(i): client i plus its neighbors, sorted ascending — the
        same ordering the dense ``ClientGraph.neighborhood`` produces,
        so zone plans (and their subsample draws) agree bit-for-bit."""
        nb = self.neighbors(i)
        return np.insert(nb, np.searchsorted(nb, i), i)

    @property
    def n_edges(self) -> int:
        return int(self.nbr_mask.sum()) // 2

    def is_connected(self) -> bool:
        return neighbor_lists_connected(self.nbrs, self.nbr_mask)

    def undirected_edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Canonical (i < j) edge arrays (ei, ej, d2), sorted by (i, j)
        — the link layer's per-edge sampling order."""
        deg = self.nbr_mask.sum(axis=1)
        ei = np.repeat(np.arange(self.n), deg)
        flat = self.nbr_mask.reshape(-1)
        ej = self.nbrs.reshape(-1)[flat]
        d2 = self.nbr_d2.reshape(-1)[flat]
        keep = ei < ej
        return ei[keep], ej[keep], d2[keep]

    def to_dense(self) -> ClientGraph:
        """Densify (small-n interop / diagnostics / equivalence tests)."""
        adj = np.zeros((self.n, self.n), dtype=bool)
        deg = self.nbr_mask.sum(axis=1)
        rows = np.repeat(np.arange(self.n), deg)
        cols = self.nbrs.reshape(-1)[self.nbr_mask.reshape(-1)]
        adj[rows, cols] = True
        return ClientGraph(adjacency=adj, positions=self.positions)


def neighbor_graph_from_dense(graph: ClientGraph) -> NeighborGraph:
    """Neighbor-list view of a dense graph (tests / migration)."""
    adj = graph.adjacency
    rows, cols = np.nonzero(adj)
    d2 = pair_sq_dists(graph.positions, rows, cols)
    return neighbor_graph_from_pairs(graph.n, rows, cols, d2,
                                     graph.positions)


def neighbor_graph_from_pairs(n: int, pi: np.ndarray, pj: np.ndarray,
                              d2: np.ndarray, positions: np.ndarray,
                              *, assume_sorted: bool = False,
                              ) -> NeighborGraph:
    """Pack directed pairs (both orientations present) into a
    :class:`NeighborGraph`. ``assume_sorted=True`` skips the lexsort
    when the pairs already arrive sorted by (i, j)."""
    pi = np.asarray(pi, dtype=np.int64)
    pj = np.asarray(pj, dtype=np.int64)
    if not assume_sorted:
        order = np.lexsort((pj, pi))
        pi, pj, d2 = pi[order], pj[order], d2[order]
    nbrs, mask, nd2 = _lists_from_sorted_pairs(n, pi, pj, d2)
    return NeighborGraph(nbrs=nbrs, nbr_mask=mask, positions=positions,
                         nbr_d2=nd2)


def segmented_arange(counts: np.ndarray) -> np.ndarray:
    """0..cᵢ−1 for each segment of a counts vector, concatenated —
    the within-group offset of every element of a group-sorted flat
    array (Σcounts entries). The shared building block of the packed
    neighbor-list constructors, the cell-list candidate generator, the
    degree-cap ranking, and the fleet fast-path planner."""
    counts = np.asarray(counts)
    total = int(counts.sum())
    return np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                        counts)


def _lists_from_sorted_pairs(n, pi, pj, d2):
    """(n, k_cap) packed arrays from (i, j)-sorted directed pairs."""
    deg = np.bincount(pi, minlength=n)
    k_cap = max(1, int(deg.max()) if len(deg) else 1)
    col = segmented_arange(deg)
    nbrs = np.zeros((n, k_cap), dtype=np.int32)
    mask = np.zeros((n, k_cap), dtype=bool)
    nd2 = np.zeros((n, k_cap), dtype=np.float64)
    nbrs[pi, col] = pj
    mask[pi, col] = True
    nd2[pi, col] = d2
    return nbrs, mask, nd2


def neighbor_lists_connected(nbrs: np.ndarray, mask: np.ndarray) -> bool:
    """Connectivity by frontier expansion over packed neighbor lists —
    O(E) per sweep instead of the dense lane's O(n²) matvec."""
    n = nbrs.shape[0]
    seen = np.zeros(n, dtype=bool)
    seen[0] = True
    frontier = np.array([0], dtype=np.int64)
    while frontier.size:
        cand = nbrs[frontier][mask[frontier]]
        new = np.unique(cand)
        new = new[~seen[new]]
        seen[new] = True
        frontier = new
    return bool(seen.all())


def _component_labels_lists(nbrs: np.ndarray, mask: np.ndarray
                            ) -> np.ndarray:
    n = nbrs.shape[0]
    labels = -np.ones(n, dtype=np.int64)
    cur = 0
    for s in range(n):
        if labels[s] >= 0:
            continue
        labels[s] = cur
        frontier = np.array([s], dtype=np.int64)
        while frontier.size:
            cand = nbrs[frontier][mask[frontier]]
            new = np.unique(cand)
            new = new[labels[new] < 0]
            labels[new] = cur
            frontier = new
        cur += 1
    return labels


def _nearest_cross_pair(pos: np.ndarray, a: np.ndarray, b: np.ndarray,
                        chunk: int = 1024) -> tuple[int, int, float]:
    """argmin over d2[a × b] without materializing the block: row-chunked
    scan with a strictly-less running best, preserving the dense lane's
    row-major first-occurrence tie-breaking (the shared
    :func:`_sum_sq_diffs` distance kernel)."""
    best = (np.inf, -1, -1)
    for s in range(0, len(a), chunk):
        rows = a[s:s + chunk]
        d2 = _sum_sq_diffs((pos[rows, c, None], pos[None, b, c])
                           for c in range(pos.shape[1]))
        flat = int(np.argmin(d2))
        ia, ib = divmod(flat, len(b))
        val = float(d2[ia, ib])
        if val < best[0]:
            best = (val, int(rows[ia]), int(b[ib]))
    return best[1], best[2], best[0]


def _insert_edge_lists(nbrs, mask, nd2, i: int, j: int, d2: float):
    """Insert undirected edge (i, j) keeping rows packed + sorted;
    grows k_cap when a row is full. Returns the (possibly re-allocated)
    arrays — callers must rebind."""
    for u, v in ((i, j), (j, i)):
        deg = int(mask[u].sum())
        if deg == nbrs.shape[1]:
            grow = max(4, nbrs.shape[1] // 2)
            nbrs = np.pad(nbrs, ((0, 0), (0, grow)))
            mask = np.pad(mask, ((0, 0), (0, grow)))
            nd2 = np.pad(nd2, ((0, 0), (0, grow)))
        pos_u = int(np.searchsorted(nbrs[u, :deg], v))
        if pos_u < deg and nbrs[u, pos_u] == v:
            continue                     # already present
        nbrs[u, pos_u + 1: deg + 1] = nbrs[u, pos_u: deg]
        nd2[u, pos_u + 1: deg + 1] = nd2[u, pos_u: deg]
        nbrs[u, pos_u] = v
        nd2[u, pos_u] = d2
        mask[u, deg] = True
    return nbrs, mask, nd2


def patch_connected_lists(nbrs, mask, nd2, positions):
    """Neighbor-list twin of :func:`patch_connected`: deterministically
    link the nearest node pair across components until connected — the
    same pair sequence the dense patch picks (component of node 0 vs the
    rest, global distance argmin), so patched sparse graphs match their
    dense oracles edge-for-edge. Returns (nbrs, mask, nd2)."""
    while not neighbor_lists_connected(nbrs, mask):
        comp = _component_labels_lists(nbrs, mask)
        a = np.flatnonzero(comp == comp[0])
        b = np.flatnonzero(comp != comp[0])
        ia, ib, d2 = _nearest_cross_pair(positions, a, b)
        nbrs, mask, nd2 = _insert_edge_lists(nbrs, mask, nd2, ia, ib, d2)
    return nbrs, mask, nd2


def line_graph(n: int) -> ClientGraph:
    """The path 0 – 1 – … – n−1: the worst-mixing connected topology."""
    adj = np.zeros((n, n), dtype=bool)
    for i in range(n - 1):
        adj[i, i + 1] = adj[i + 1, i] = True
    pos = np.stack([np.linspace(0, 1, n), np.zeros(n)], axis=1)
    return ClientGraph(adjacency=adj, positions=pos)


def complete_graph(n: int) -> ClientGraph:
    """Every pair linked, clients on the unit circle."""
    adj = ~np.eye(n, dtype=bool)
    pos = np.stack(
        [np.cos(np.linspace(0, 2 * np.pi, n, endpoint=False)),
         np.sin(np.linspace(0, 2 * np.pi, n, endpoint=False))],
        axis=1,
    )
    return ClientGraph(adjacency=adj, positions=pos)
