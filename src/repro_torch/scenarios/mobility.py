"""Mobility models: client positions → per-round connectivity graphs.

All models run host-side (control plane) and share one contract:

    reset(rng) -> ClientGraph     # round-0 graph
    step(rng)  -> ClientGraph     # advance one round
    rollout(rounds, rng) -> list[ClientGraph]   # batched step×rounds

plus a positions-only lane for consumers that never touch connectivity
(the FedAvg-family base-station baselines — ``scenarios.Scenario``'s
``positions_only`` mode):

    reset_positions(rng) -> (n, 2)
    step_positions(rng)  -> (n, 2)

``rollout`` and the positions-only lane consume the RNG exactly as the
same number of ``step()`` calls would, so every lane replays every other
lane draw-for-draw.
``rollout`` batches the O(n²) work — pairwise distances, range/kNN
adjacency, degree patching, connectivity checks — across the whole
window in a few vectorized passes; position *advancement* stays a cheap
O(n) per-round recurrence (it is inherently sequential: waypoint
arrivals and boundary reflections depend on the previous round).

Connectivity for the smooth models derives from a radio range — an edge
(i, j) exists iff ‖p_i − p_j‖ ≤ radio_range — then a ``min_degree``
nearest-neighbor floor and a deterministic connected-components patch
keep the walk chain irreducible (Assumption 3.1), matching the paper's
"at least 5 neighboring nodes" App. D.2 construction.

``static_regen`` reproduces ``core.graph.DynamicGraph``'s draw
sequence bit-for-bit: i.i.d. ``random_geometric_graph`` redraws every
``regen_every`` rounds and *no* RNG consumption in between.

Port of ``repro/scenarios/mobility.py``: every model consumes its RNG
draw for draw as the reference's does. Traces are arrays already on the
machine (``register_trace``) or ``.npz``/``.npy`` files; nothing is
fetched.
"""
from __future__ import annotations

from typing import Protocol

import numpy as np

from ..core.graph import (
    ClientGraph,
    NeighborGraph,
    graphs_from_stack,
    knn_adjacency,
    neighbor_graph_from_pairs,
    pair_sq_dists,
    pairwise_sq_dists,
    pairwise_sq_dists_batch,
    patch_connected,
    patch_connected_lists,
    random_geometric_graph,
    seed_sq_dist_cache,
    segmented_arange,
)
from .config import MobilityConfig

GRAPH_BACKENDS = ("dense", "sparse")


class MobilityModel(Protocol):
    def reset(self, rng: np.random.Generator) -> ClientGraph: ...

    def step(self, rng: np.random.Generator) -> ClientGraph: ...

    def rollout(self, rounds: int,
                rng: np.random.Generator) -> list[ClientGraph]: ...

    def reset_positions(self, rng: np.random.Generator) -> np.ndarray: ...

    def step_positions(self, rng: np.random.Generator) -> np.ndarray: ...


def range_graph(pos: np.ndarray, radio_range: float,
                min_degree: int) -> ClientGraph:
    """Geometric connectivity: radio-range disk graph with a min-degree
    patch (nodes below the degree floor get their nearest neighbors
    linked in), patched connected. Deterministic given positions; runs
    every round for the smooth mobility models, so the k-NN work is
    restricted to the deficient rows only.
    """
    n = pos.shape[0]
    d2 = pairwise_sq_dists(pos)
    adj = d2 <= radio_range * radio_range
    np.fill_diagonal(adj, False)
    k = min(min_degree, n - 1)
    deficient = np.flatnonzero(adj.sum(axis=1) < k)
    if len(deficient) and k > 0:
        nearest = np.argpartition(d2[deficient], k - 1, axis=1)[:, :k]
        adj[deficient[:, None], nearest] = True
        adj[nearest, deficient[:, None]] = True
    adj = patch_connected(adj, d2)
    graph = ClientGraph(adjacency=adj, positions=pos)
    seed_sq_dist_cache(graph, d2)
    return graph


def range_graphs_batch(pos: np.ndarray, radio_range: float,
                       min_degree: int) -> list[ClientGraph]:
    """Batched :func:`range_graph`: R graphs from (R, n, 2) positions.

    One (R, n, n) distance pass, one vectorized degree patch over all
    deficient rows of all rounds at once, one batched connectivity
    check; only rounds that actually come out disconnected pay the
    per-graph component patch. Deterministic and bit-identical to R
    per-round ``range_graph`` calls (same argpartition per row, same
    patch order).
    """
    n = pos.shape[1]
    d2 = pairwise_sq_dists_batch(pos)
    adj = d2 <= radio_range * radio_range       # inf diagonal → False
    k = min(min_degree, n - 1)
    if k > 0:
        r_idx, i_idx = np.nonzero(adj.sum(axis=2) < k)
        if len(r_idx):
            nearest = np.argpartition(d2[r_idx, i_idx], k - 1,
                                      axis=1)[:, :k]
            adj[r_idx[:, None], i_idx[:, None], nearest] = True
            adj[r_idx[:, None], nearest, i_idx[:, None]] = True
    return graphs_from_stack(adj, d2, pos)


# ---------------------------------------------------------------------------
# Sparse backend: grid-bucket (cell-list) neighbor search.
#
# The dense lane's O(n²) distance matrix is what blocks large n. The
# sparse lane buckets positions into a uniform grid of cells no smaller
# than the search radius, so every within-radius pair lives in a 3×3
# cell neighborhood: candidate generation is O(n · local density), and
# the resulting graphs are capped-degree neighbor lists — O(n·k) end to
# end. Where the construction is RNG-free (it is: graphs are a
# deterministic function of positions) the sparse graphs are pinned
# bit-identical to the dense lane at small n.
# ---------------------------------------------------------------------------


class _CellGrid:
    """Uniform unit-square grid with CSR-style cell membership."""

    def __init__(self, pos: np.ndarray, cell_size: float):
        self.pos = pos
        self.nc = max(1, int(np.floor(1.0 / max(cell_size, 1e-9))))
        self.side = 1.0 / self.nc
        self.cx = np.clip((pos[:, 0] * self.nc).astype(np.int64),
                          0, self.nc - 1)
        self.cy = np.clip((pos[:, 1] * self.nc).astype(np.int64),
                          0, self.nc - 1)
        cid = self.cx * self.nc + self.cy
        self.order = np.argsort(cid, kind="stable")
        self._sorted_cid = cid[self.order]

    def _cell_bounds(self, cids: np.ndarray):
        starts = np.searchsorted(self._sorted_cid, cids)
        ends = np.searchsorted(self._sorted_cid, cids, side="right")
        return starts, ends

    def candidate_pairs(self, max_pairs: int = 60_000_000
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Directed candidate pairs (i, j), i ≠ j, over every node's 3×3
        cell neighborhood (symmetric by construction). Raises when the
        candidate count explodes — the signal that the radio range is
        far too large for the node density (the sparse backend expects a
        local graph; shrink ``radio_range`` or use the dense lane)."""
        n = self.pos.shape[0]
        nc = self.nc
        pis, pjs = [], []
        total = 0
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                nx, ny = self.cx + dx, self.cy + dy
                ok = (nx >= 0) & (nx < nc) & (ny >= 0) & (ny < nc)
                ncid = np.where(ok, nx * nc + ny, 0)
                starts, ends = self._cell_bounds(ncid)
                cnt = np.where(ok, ends - starts, 0)
                block = int(cnt.sum())
                total += block
                if total > max_pairs:
                    raise ValueError(
                        f"cell-list search would generate > {max_pairs} "
                        "candidate pairs — the search radius is too "
                        "large for n (the graph is effectively dense). "
                        "Reduce radio_range (or min_degree) for the "
                        "sparse backend, or use graph_backend='dense'.")
                if not block:
                    continue
                pi = np.repeat(np.arange(n), cnt)
                within = segmented_arange(cnt)
                pj = self.order[np.repeat(starts, cnt) + within]
                keep = pi != pj
                pis.append(pi[keep])
                pjs.append(pj[keep])
        if not pis:
            e = np.zeros(0, dtype=np.int64)
            return e, e.copy()
        return np.concatenate(pis), np.concatenate(pjs)

    def ring_nodes(self, i: int, r: int) -> np.ndarray:
        """Nodes in cells at Chebyshev cell-distance exactly ``r`` from
        node i's cell (every one of them is ≥ (r−1)·side away)."""
        cxi, cyi = int(self.cx[i]), int(self.cy[i])
        if r == 0:
            cells = [(cxi, cyi)]
        else:
            cells = []
            for x in range(cxi - r, cxi + r + 1):
                for y in (cyi - r, cyi + r):
                    cells.append((x, y))
            for y in range(cyi - r + 1, cyi + r):
                for x in (cxi - r, cxi + r):
                    cells.append((x, y))
        cells = [(x, y) for x, y in cells
                 if 0 <= x < self.nc and 0 <= y < self.nc]
        if not cells:
            return np.zeros(0, dtype=np.int64)
        cids = np.asarray([x * self.nc + y for x, y in cells])
        starts, ends = self._cell_bounds(cids)
        return np.concatenate([self.order[s:e]
                               for s, e in zip(starts, ends)]) \
            if len(cids) else np.zeros(0, dtype=np.int64)

    def exact_knn(self, i: int, k: int) -> np.ndarray:
        """The k nearest neighbors of node i, exactly: expand cell
        rings until the k-th candidate is provably closer than anything
        unexamined (ring r+1 nodes are ≥ r·side away)."""
        cand: list[np.ndarray] = []
        count = 0
        r = 0
        max_r = 2 * self.nc + 1
        while True:
            ring = self.ring_nodes(i, r)
            ring = ring[ring != i]
            if len(ring):
                cand.append(ring)
                count += len(ring)
            if count >= k:
                ids = np.concatenate(cand)
                d2 = pair_sq_dists(self.pos, np.full(len(ids), i), ids)
                kth = np.partition(d2, k - 1)[k - 1]
                if kth < (r * self.side) ** 2 or r > max_r:
                    nearest = ids[np.argpartition(d2, k - 1)[:k]]
                    return nearest
            elif r > max_r:
                return (np.concatenate(cand) if cand
                        else np.zeros(0, dtype=np.int64))
            r += 1


def _cap_degree_pairs(n: int, pi, pj, d2, k_max: int):
    """Truncate per-node degree to the ``k_max`` nearest, then drop the
    asymmetric leftovers (an edge survives only if both endpoints keep
    it) so the graph stays undirected. Returns (i, j)-sorted pairs."""
    order = np.lexsort((pj, pi))
    pi, pj, d2 = pi[order], pj[order], d2[order]
    deg = np.bincount(pi, minlength=n)
    if not len(pi) or deg.max() <= k_max:
        return pi, pj, d2
    by_dist = np.lexsort((d2, pi))
    rank = np.empty(len(pi), dtype=np.int64)
    rank[by_dist] = segmented_arange(deg)
    keep_dir = rank < k_max
    key = pi * n + pj
    ridx = np.searchsorted(key, pj * n + pi)
    keep = keep_dir & keep_dir[ridx]
    return pi[keep], pj[keep], d2[keep]


def _patch_min_degree_lists(nbrs, mask, nd2, pos, grid: _CellGrid,
                            k: int):
    """Link each below-floor node to its exact k nearest neighbors
    (expanding-ring search; deficient rows only — the same semantics as
    the dense lane's argpartition patch). Returns (nbrs, mask, nd2)."""
    if k <= 0:
        return nbrs, mask, nd2
    from ..core.graph import _insert_edge_lists

    deg = mask.sum(axis=1)
    for i in np.flatnonzero(deg < k):
        for j in grid.exact_knn(int(i), k):
            e2 = float(pair_sq_dists(pos, np.asarray([i]),
                                     np.asarray([j]))[0])
            nbrs, mask, nd2 = _insert_edge_lists(
                nbrs, mask, nd2, int(i), int(j), e2)
    return nbrs, mask, nd2


def sparse_range_graph(pos: np.ndarray, radio_range: float,
                       min_degree: int, k_max: int) -> NeighborGraph:
    """Neighbor-list twin of :func:`range_graph`: radio-range disk graph
    from a cell-list search (no O(n²) distance matrix), the same
    min-degree patch (exact k nearest for deficient nodes, via expanding
    cell rings), the same deterministic connectivity patch. With
    ``k_max`` ≥ the realized max degree this is edge-for-edge identical
    to the dense lane (pinned); tighter ``k_max`` keeps only each node's
    nearest ``k_max`` in-range links — the O(n·k) memory cap."""
    n = pos.shape[0]
    grid = _CellGrid(pos, radio_range)
    pi, pj = grid.candidate_pairs()
    d2 = pair_sq_dists(pos, pi, pj)
    keep = d2 <= radio_range * radio_range
    pi, pj, d2 = pi[keep], pj[keep], d2[keep]
    pi, pj, d2 = _cap_degree_pairs(n, pi, pj, d2, k_max)
    graph = neighbor_graph_from_pairs(n, pi, pj, d2, pos,
                                      assume_sorted=True)
    nbrs, mask, nd2 = _patch_min_degree_lists(
        graph.nbrs, graph.nbr_mask, graph.nbr_d2, pos, grid,
        min(min_degree, n - 1))
    nbrs, mask, nd2 = patch_connected_lists(nbrs, mask, nd2, pos)
    return NeighborGraph(nbrs=nbrs, nbr_mask=mask, positions=pos,
                         nbr_d2=nd2)


def sparse_knn_graph(pos: np.ndarray, min_degree: int,
                     k_max: int) -> NeighborGraph:
    """Neighbor-list twin of ``random_geometric_graph``'s body for given
    positions: symmetrized k-nearest-neighbor adjacency + connectivity
    patch, built from a cell-list search sized so the 3×3 block around a
    node is expected to hold ≳ 9·(k+2) candidates. Nodes whose k-th
    candidate isn't provably nearest fall back to the exact
    expanding-ring search. Bit-identical graphs to the dense lane
    (``knn_adjacency`` + ``patch_connected``) — pinned."""
    n = pos.shape[0]
    k = min(min_degree, n - 1)
    if k <= 0:
        e = np.zeros(0, dtype=np.int64)
        g = neighbor_graph_from_pairs(n, e, e.copy(),
                                      np.zeros(0), pos)
        nbrs, mask, nd2 = patch_connected_lists(
            g.nbrs, g.nbr_mask, g.nbr_d2, pos)
        return NeighborGraph(nbrs=nbrs, nbr_mask=mask, positions=pos,
                             nbr_d2=nd2)
    cell = min(max(np.sqrt((k + 2.0) / n), 1e-3), 1.0)
    grid = _CellGrid(pos, cell)
    pi, pj = grid.candidate_pairs()
    d2 = pair_sq_dists(pos, pi, pj)
    by_dist = np.lexsort((d2, pi))
    pi, pj, d2 = pi[by_dist], pj[by_dist], d2[by_dist]
    cnt = np.bincount(pi, minlength=n)
    rank = segmented_arange(cnt)
    take = rank < k
    # Safe iff the node has ≥ k candidates and its k-th candidate beats
    # the 1-cell-gap distance floor of everything unexamined.
    kth = np.full(n, np.inf)
    kth[pi[rank == k - 1]] = d2[rank == k - 1]
    safe = (cnt >= k) & (kth < grid.side ** 2)
    take &= safe[pi]
    ei = [pi[take]]
    ej = [pj[take]]
    for i in np.flatnonzero(~safe):
        nb = grid.exact_knn(int(i), k)
        ei.append(np.full(len(nb), i, dtype=np.int64))
        ej.append(nb.astype(np.int64))
    ei = np.concatenate(ei)
    ej = np.concatenate(ej)
    # Symmetrize (union of directed kNN edges), dedup via canonical keys.
    keys = np.unique(np.concatenate([ei * n + ej, ej * n + ei]))
    pi, pj = keys // n, keys % n
    d2u = pair_sq_dists(pos, pi, pj)
    # Apply the degree cap (hub nodes of the symmetrized union collect
    # every incoming kNN edge), then re-floor: a node whose own kNN
    # edges were dropped by a capped hub gets its k nearest re-linked —
    # so the cap stays soft exactly as on the range lane. With k_max ≥
    # the realized max degree (the dense-parity regime) both steps are
    # no-ops.
    pi, pj, d2u = _cap_degree_pairs(n, pi, pj, d2u, k_max)
    graph = neighbor_graph_from_pairs(n, pi, pj, d2u, pos,
                                      assume_sorted=True)
    nbrs, mask, nd2 = _patch_min_degree_lists(
        graph.nbrs, graph.nbr_mask, graph.nbr_d2, pos, grid, k)
    nbrs, mask, nd2 = patch_connected_lists(nbrs, mask, nd2, pos)
    return NeighborGraph(nbrs=nbrs, nbr_mask=mask, positions=pos,
                         nbr_d2=nd2)


def _knn_graphs_batch(pos: np.ndarray, min_degree: int) -> list[ClientGraph]:
    """Batched ``random_geometric_graph`` body for pre-drawn positions:
    kNN adjacency + connectivity patch per frame, distances in one pass.
    Bit-identical to per-frame construction (rows partition independently).
    """
    d2 = pairwise_sq_dists_batch(pos)
    adj = np.stack([knn_adjacency(d2[r], min_degree)
                    for r in range(pos.shape[0])])
    return graphs_from_stack(adj, d2, pos)


class StaticRegenMobility:
    """The seed behavior: positions redrawn i.i.d. every ``regen_every``
    rounds (``core.graph.DynamicGraph``), static in between."""

    def __init__(self, n: int, cfg: MobilityConfig,
                 backend: str = "dense", k_max: int = 64):
        self.n = n
        self.cfg = cfg
        self.backend = backend
        self.k_max = k_max
        self.regen_every = max(1, cfg.regen_every)
        self._round = 0
        self.n_regens = 0
        self.graph: ClientGraph | NeighborGraph | None = None
        self.pos: np.ndarray | None = None

    def _regen(self, rng: np.random.Generator):
        """One i.i.d. redraw. Both backends consume the RNG identically
        (one (n, 2) uniform draw; graph construction is RNG-free)."""
        if self.backend == "sparse":
            pos = rng.uniform(0.0, 1.0, size=(self.n, 2))
            return sparse_knn_graph(pos, self.cfg.min_degree, self.k_max)
        return random_geometric_graph(self.n, self.cfg.min_degree, rng)

    def reset(self, rng: np.random.Generator) -> ClientGraph:
        self._round = 0
        self.n_regens = 0
        self.graph = self._regen(rng)
        self.pos = self.graph.positions
        return self.graph

    def step(self, rng: np.random.Generator) -> ClientGraph:
        self._round += 1
        if self._round % self.regen_every == 0:
            self.graph = self._regen(rng)
            self.pos = self.graph.positions
            self.n_regens += 1
        return self.graph

    def rollout(self, rounds: int,
                rng: np.random.Generator) -> list[ClientGraph]:
        """``rounds`` steps in one pass: draw every regen epoch's
        positions as one (K, n, 2) block (bit-identical to K sequential
        draws), build the K graphs batched, repeat objects in between
        (so downstream per-graph caches keep hitting)."""
        rs = np.arange(self._round + 1, self._round + rounds + 1)
        regen = rs % self.regen_every == 0
        k = int(regen.sum())
        fresh: list[ClientGraph] = []
        if k:
            pos = rng.uniform(0.0, 1.0, size=(k, self.n, 2))
            if self.backend == "sparse":
                # O(n·k) per frame — no (R, n, n) stack to batch over.
                fresh = [sparse_knn_graph(pos[r], self.cfg.min_degree,
                                          self.k_max)
                         for r in range(k)]
            else:
                fresh = _knn_graphs_batch(pos, self.cfg.min_degree)
        out: list[ClientGraph] = []
        j = 0
        cur = self.graph
        for flag in regen:
            if flag:
                cur = fresh[j]
                j += 1
                self.n_regens += 1
            out.append(cur)
        self._round += rounds
        self.graph = cur
        self.pos = cur.positions
        return out

    def reset_positions(self, rng: np.random.Generator) -> np.ndarray:
        self._round = 0
        self.n_regens = 0
        self.graph = None
        self.pos = rng.uniform(0.0, 1.0, size=(self.n, 2))
        return self.pos

    def step_positions(self, rng: np.random.Generator) -> np.ndarray:
        self._round += 1
        if self._round % self.regen_every == 0:
            self.pos = rng.uniform(0.0, 1.0, size=(self.n, 2))
            self.n_regens += 1
        return self.pos


class RandomWaypointMobility:
    """Random waypoint: each client walks toward a uniform waypoint at a
    per-leg speed ∈ [speed_min, speed_max], pauses ``pause_rounds`` on
    arrival, then draws the next leg. The classic ad-hoc-network model
    (Johnson & Maltz); positions move ≤ speed_max per round, so graphs
    evolve smoothly instead of redrawing."""

    def __init__(self, n: int, cfg: MobilityConfig,
                 backend: str = "dense", k_max: int = 64):
        self.n = n
        self.cfg = cfg
        self.backend = backend
        self.k_max = k_max

    def reset_positions(self, rng: np.random.Generator) -> np.ndarray:
        self.pos = rng.uniform(0.0, 1.0, size=(self.n, 2))
        self.waypoint = rng.uniform(0.0, 1.0, size=(self.n, 2))
        self.speed = rng.uniform(self.cfg.speed_min, self.cfg.speed_max,
                                 size=self.n)
        self.pause = np.zeros(self.n, dtype=np.int64)
        return self.pos

    def step_positions(self, rng: np.random.Generator) -> np.ndarray:
        delta = self.waypoint - self.pos
        dist = np.linalg.norm(delta, axis=1)
        moving = (self.pause == 0) & (dist > 1e-12)
        frac = np.where(dist > 1e-12,
                        np.minimum(1.0, self.speed / np.maximum(dist, 1e-12)),
                        0.0)
        self.pos = self.pos + (moving * frac)[:, None] * delta
        arrived = moving & (frac >= 1.0)
        self.pause = np.maximum(self.pause - 1, 0)
        self.pause[arrived] = self.cfg.pause_rounds
        # Draw the next leg for every arrival (boolean indexing consumes
        # the RNG in client order, so replays are deterministic).
        if arrived.any():
            k = int(arrived.sum())
            self.waypoint[arrived] = rng.uniform(0.0, 1.0, size=(k, 2))
            self.speed[arrived] = rng.uniform(
                self.cfg.speed_min, self.cfg.speed_max, size=k)
        return self.pos

    def reset(self, rng: np.random.Generator) -> ClientGraph:
        return self._graph(self.reset_positions(rng))

    def step(self, rng: np.random.Generator) -> ClientGraph:
        return self._graph(self.step_positions(rng))

    def rollout(self, rounds: int,
                rng: np.random.Generator) -> list[ClientGraph]:
        """Advance positions round-by-round (O(n) each; waypoint-arrival
        draws are data-dependent, so the RNG order must stay per-step),
        then build all ``rounds`` graphs in one batched pass."""
        pos = np.empty((rounds, self.n, 2))
        for t in range(rounds):
            pos[t] = self.step_positions(rng)
        return _range_rollout_graphs(pos, self.cfg, self.backend,
                                     self.k_max)

    def _graph(self, pos: np.ndarray) -> ClientGraph:
        if self.backend == "sparse":
            return sparse_range_graph(pos, self.cfg.radio_range,
                                      self.cfg.min_degree, self.k_max)
        return range_graph(pos, self.cfg.radio_range,
                           self.cfg.min_degree)


def _range_rollout_graphs(pos: np.ndarray, cfg: MobilityConfig,
                          backend: str, k_max: int):
    """Rollout tail shared by the smooth models: dense batches the
    (R, n, n) construction; sparse builds each frame's O(n·k) neighbor
    lists (there is no quadratic stack to batch over — the per-frame
    cell-list pass IS the batched form)."""
    if backend == "sparse":
        return [sparse_range_graph(pos[t], cfg.radio_range,
                                   cfg.min_degree, k_max)
                for t in range(pos.shape[0])]
    return range_graphs_batch(pos, cfg.radio_range, cfg.min_degree)


class GaussMarkovMobility:
    """Gauss-Markov: temporally correlated velocities,

        v_{t+1} = α v_t + (1 − α) v̄_i + σ √(1 − α²) w_t,

    with per-client mean velocities v̄_i (magnitude ``mean_speed``,
    uniform heading) and boundary reflection. α → 1 gives straight-line
    motion, α → 0 memoryless Brownian drift (Camp et al. survey §2.5)."""

    def __init__(self, n: int, cfg: MobilityConfig,
                 backend: str = "dense", k_max: int = 64):
        self.n = n
        self.cfg = cfg
        self.backend = backend
        self.k_max = k_max

    def reset_positions(self, rng: np.random.Generator) -> np.ndarray:
        self.pos = rng.uniform(0.0, 1.0, size=(self.n, 2))
        heading = rng.uniform(0.0, 2 * np.pi, size=self.n)
        self.mean_v = self.cfg.mean_speed * np.stack(
            [np.cos(heading), np.sin(heading)], axis=1)
        self.vel = self.mean_v.copy()
        return self.pos

    def step_positions(self, rng: np.random.Generator) -> np.ndarray:
        return self._advance(rng.normal(size=(self.n, 2)))

    def _advance(self, noise: np.ndarray) -> np.ndarray:
        a, s = self.cfg.alpha, self.cfg.sigma_speed
        self.vel = (a * self.vel + (1.0 - a) * self.mean_v
                    + s * np.sqrt(max(1.0 - a * a, 0.0)) * noise)
        self.pos = self.pos + self.vel
        # Reflect at the unit-square boundary (flip offending velocity
        # components; mean heading reflects too so clients don't fight
        # the wall forever).
        for lo, hi in ((0.0, 1.0),):
            under, over = self.pos < lo, self.pos > hi
            self.pos = np.where(under, 2 * lo - self.pos, self.pos)
            self.pos = np.where(over, 2 * hi - self.pos, self.pos)
            flip = under | over
            self.vel = np.where(flip, -self.vel, self.vel)
            self.mean_v = np.where(flip, -self.mean_v, self.mean_v)
        self.pos = np.clip(self.pos, 0.0, 1.0)
        return self.pos

    def reset(self, rng: np.random.Generator) -> ClientGraph:
        return self._graph(self.reset_positions(rng))

    def step(self, rng: np.random.Generator) -> ClientGraph:
        return self._graph(self.step_positions(rng))

    def rollout(self, rounds: int,
                rng: np.random.Generator) -> list[ClientGraph]:
        """One (rounds, n, 2) normal block (bit-identical to per-round
        draws), a cheap sequential velocity/reflection recurrence, then
        one batched graph-construction pass."""
        noise = rng.normal(size=(rounds, self.n, 2))
        pos = np.empty((rounds, self.n, 2))
        for t in range(rounds):
            pos[t] = self._advance(noise[t])
        return _range_rollout_graphs(pos, self.cfg, self.backend,
                                     self.k_max)

    def _graph(self, pos: np.ndarray) -> ClientGraph:
        if self.backend == "sparse":
            return sparse_range_graph(pos, self.cfg.radio_range,
                                      self.cfg.min_degree, self.k_max)
        return range_graph(pos, self.cfg.radio_range,
                           self.cfg.min_degree)


# ---------------------------------------------------------------------------
# Trace replay: recorded (R, n, 2) positions, e.g. from a field trial or
# an external mobility simulator.
# ---------------------------------------------------------------------------

_TRACES: dict[str, np.ndarray] = {}


def _validate_trace(pos: np.ndarray) -> np.ndarray:
    if pos.ndim != 3 or pos.shape[2] != 2 or pos.shape[0] < 1:
        raise ValueError(
            f"trace must be a (R, n, 2) position array with R >= 1, "
            f"got shape {pos.shape}")
    if not np.isfinite(pos).all():
        raise ValueError("trace positions must be finite")
    if pos.min() < 0.0 or pos.max() > 1.0:
        raise ValueError("trace positions must lie in the unit square")
    return pos


def register_trace(name: str, positions: np.ndarray) -> np.ndarray:
    """Register an in-memory (R, n, 2) unit-square position trace under
    ``name`` so a plain-string ``MobilityConfig(model="trace",
    trace_path=name)`` can refer to it (configs stay frozen/hashable —
    no array-valued fields). Returns the validated float64 copy."""
    pos = _validate_trace(np.array(positions, np.float64))
    _TRACES[name] = pos
    return pos


def load_trace(spec: str) -> np.ndarray:
    """Resolve a trace spec: a ``register_trace`` name, an ``.npz`` file
    holding a ``"positions"`` array, or a bare ``.npy`` array file."""
    if not spec:
        raise ValueError(
            "mobility model 'trace' needs MobilityConfig.trace_path "
            "(a register_trace name or an .npz/.npy file)")
    if spec in _TRACES:
        return _TRACES[spec]
    if spec.endswith(".npz"):
        with np.load(spec) as z:
            if "positions" not in z:
                raise ValueError(
                    f"{spec!r} has no 'positions' array "
                    f"(found: {sorted(z.files)})")
            return _validate_trace(np.asarray(z["positions"], np.float64))
    if spec.endswith(".npy"):
        return _validate_trace(np.asarray(np.load(spec), np.float64))
    raise ValueError(
        f"unknown trace {spec!r}: not a registered name "
        f"(known: {sorted(_TRACES)}) and not an .npz/.npy path")


class TraceMobility:
    """Replay recorded positions: round t shows frame ``t mod R`` of the
    (R, n, 2) trace named by ``cfg.trace_path`` (wrap-around looping).
    Consumes **no** RNG, so swapping a synthetic model for a trace leaves
    every other stream (links, churn, walker) untouched, and replays are
    exact by construction. Graphs derive from ``radio_range``/
    ``min_degree`` exactly like the smooth models."""

    def __init__(self, n: int, cfg: MobilityConfig,
                 backend: str = "dense", k_max: int = 64):
        self.n = n
        self.cfg = cfg
        self.backend = backend
        self.k_max = k_max
        self.trace = load_trace(cfg.trace_path)
        if self.trace.shape[1] != n:
            raise ValueError(
                f"trace {cfg.trace_path!r} has {self.trace.shape[1]} "
                f"clients, scenario has {n}")
        self._t = 0

    def reset_positions(self, rng: np.random.Generator) -> np.ndarray:
        self._t = 0
        self.pos = self.trace[0]
        return self.pos

    def step_positions(self, rng: np.random.Generator) -> np.ndarray:
        self._t += 1
        self.pos = self.trace[self._t % len(self.trace)]
        return self.pos

    def reset(self, rng: np.random.Generator) -> ClientGraph:
        return self._graph(self.reset_positions(rng))

    def step(self, rng: np.random.Generator) -> ClientGraph:
        return self._graph(self.step_positions(rng))

    def rollout(self, rounds: int,
                rng: np.random.Generator) -> list[ClientGraph]:
        """Slice the next ``rounds`` frames (with wrap-around) and push
        them through the shared batched graph-construction tail."""
        idx = (self._t + 1 + np.arange(rounds)) % len(self.trace)
        pos = self.trace[idx]
        self._t += rounds
        if rounds:
            self.pos = pos[-1]
        return _range_rollout_graphs(pos, self.cfg, self.backend,
                                     self.k_max)

    def _graph(self, pos: np.ndarray) -> ClientGraph:
        if self.backend == "sparse":
            return sparse_range_graph(pos, self.cfg.radio_range,
                                      self.cfg.min_degree, self.k_max)
        return range_graph(pos, self.cfg.radio_range,
                           self.cfg.min_degree)


_MODELS = {
    "static_regen": StaticRegenMobility,
    "random_waypoint": RandomWaypointMobility,
    "gauss_markov": GaussMarkovMobility,
    "trace": TraceMobility,
}


def build_mobility(n: int, cfg: MobilityConfig, *, backend: str = "dense",
                   k_max: int = 64) -> MobilityModel:
    try:
        cls = _MODELS[cfg.model]
    except KeyError:
        raise ValueError(
            f"unknown mobility model {cfg.model!r}; "
            f"known: {sorted(_MODELS)}") from None
    if backend not in GRAPH_BACKENDS:
        raise ValueError(
            f"graph_backend must be one of {'|'.join(GRAPH_BACKENDS)}, "
            f"got {backend!r}")
    return cls(n, cfg, backend=backend, k_max=int(k_max))
