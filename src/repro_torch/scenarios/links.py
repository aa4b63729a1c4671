"""Wireless link layer: path loss → success probability → dropouts,
plus the comm-cost model pricing each round in bytes/latency/energy.

Log-distance path loss with shadowing (Rappaport Ch. 4):

    PL(d) = PL₀ + 10 η log₁₀(max(d, d₀)/d₀)        [dB]
    M(d)  = P_tx − P_sens − PL(d)                   fade margin [dB]
    p(d)  = clip(σ(M(d)/s_sh), p_min, 1)            link success prob,

where the log-normal shadowing is folded into a logistic curve of the
margin (scale ``shadowing_db``) — the standard sigmoid outage
approximation, dependency-free and monotone-decreasing in distance.

Stochastic dropouts draw each edge ~ Bernoulli(p(d)) per round and then
re-patch connectivity (deterministically, nearest across components) so
the random-walk chain stays irreducible.

``CommModel`` prices a zone round under the first-order radio model
(Heinzelman et al. 2000): the server broadcasts the token y once at the
power needed to reach the farthest zone member, each active client
uploads its contribution over its own link, and expected retransmissions
1/p(d) scale both latency and energy. All pricing is deterministic given
the zone — no RNG — so eager and scan engines price identically.

Port of ``repro/scenarios/links.py``: the same float64 operations in the
same order, so the prices equal the reference's by ``==``.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import (
    ClientGraph,
    NeighborGraph,
    graph_sq_dists,
    graphs_from_stack,
    neighbor_graph_from_pairs,
    patch_connected,
    patch_connected_lists,
    seed_sq_dist_cache,
)
from .config import CommConfig, LinkConfig


class LinkModel:
    """Per-link success probabilities + per-round stochastic dropouts.

    Both graph backends are served: dense ``ClientGraph``s sample a
    symmetric (n, n) uniform matrix per round; sparse ``NeighborGraph``s
    sample one uniform per *undirected edge* (canonical (i < j) order) —
    O(n·k) instead of O(n²) per round. The two lanes draw different
    uniform counts, so **enabling dropout is an RNG-stream break between
    backends** (each lane is individually deterministic and
    chunk-composable; the sparse stream is pinned by a seed-stability
    test). Everything RNG-free — success probabilities, pricing — is
    bit-identical across backends.
    """

    def __init__(self, cfg: LinkConfig):
        self.cfg = cfg
        # Distances/probabilities depend only on the base (mobility)
        # graph, which under static_regen changes every ``regen_every``
        # rounds while dropouts redraw every round — cache per graph
        # instance (weakref so a recycled id can't alias a dead graph).
        self._cache: tuple | None = None

    def _geometry(self, graph: ClientGraph):
        """(d2, link success matrix) for ``graph``, cached per instance."""
        import weakref

        if self._cache is not None and self._cache[0]() is graph:
            return self._cache[1], self._cache[2]
        d2 = graph_sq_dists(graph)
        finite = np.where(np.isfinite(d2), d2, 0.0)   # inf diagonal
        p = np.where(graph.adjacency,
                     self.success_probability_sq(finite), 0.0)
        self._cache = (weakref.ref(graph), d2, p)
        return d2, p

    def success_probability(self, dist: np.ndarray) -> np.ndarray:
        """p(d) for an array of distances (elementwise, vectorized)."""
        return self.success_probability_sq(
            np.square(np.asarray(dist, dtype=np.float64)))

    def success_probability_sq(self, d2: np.ndarray) -> np.ndarray:
        """p as a function of *squared* distance.

        Algebraically identical to the logistic-of-margin form in the
        module docstring:  σ(M(d)/s) = 1 / (1 + C · (d²/d₀²)^(q/2))
        with C = exp(−M(d₀)/s) and q = 10η/(s·ln10) — no sqrt/log10
        over the (n, n) matrix (this runs every round under dropout
        scenarios).
        """
        c = self.cfg
        s = max(c.shadowing_db, 1e-6)
        m0 = c.tx_power_dbm - c.sensitivity_dbm - c.ref_loss_db
        big_c = np.exp(-m0 / s)
        q = 10.0 * c.path_loss_exp / (s * np.log(10.0))
        ratio = np.maximum(
            np.asarray(d2, dtype=np.float64) / c.ref_distance**2, 1.0)
        p = 1.0 / (1.0 + big_c * ratio ** (q / 2.0))
        return np.clip(p, c.min_success, 1.0)

    def link_matrix(self, graph: ClientGraph) -> np.ndarray:
        """(n, n) success probabilities on the graph's edges, 0 elsewhere."""
        return self._geometry(graph)[1]

    def _edge_geometry(self, graph: NeighborGraph):
        """Canonical-edge arrays (ei, ej, d2, p) for a sparse graph,
        cached per graph instance (same policy as :meth:`_geometry`)."""
        import weakref

        if self._cache is not None and self._cache[0]() is graph:
            return self._cache[1]
        ei, ej, d2 = graph.undirected_edges()
        p = self.success_probability_sq(d2)
        self._cache = (weakref.ref(graph), (ei, ej, d2, p))
        return ei, ej, d2, p

    def _apply_dropouts_sparse(self, graph: NeighborGraph,
                               rng: np.random.Generator
                               ) -> NeighborGraph:
        """One uniform per undirected edge in canonical (i < j) order
        (symmetric outcome by construction), survivors re-packed into
        neighbor lists and re-patched connected."""
        ei, ej, d2, p = self._edge_geometry(graph)
        u = rng.uniform(size=len(ei))
        keep = u < p
        pi = np.concatenate([ei[keep], ej[keep]])
        pj = np.concatenate([ej[keep], ei[keep]])
        ed2 = np.concatenate([d2[keep], d2[keep]])
        out = neighbor_graph_from_pairs(graph.n, pi, pj, ed2,
                                        graph.positions)
        nbrs, mask, nd2 = patch_connected_lists(
            out.nbrs, out.nbr_mask, out.nbr_d2, graph.positions)
        return NeighborGraph(nbrs=nbrs, nbr_mask=mask,
                             positions=graph.positions, nbr_d2=nd2)

    def apply_dropouts(self, graph: ClientGraph,
                       rng: np.random.Generator) -> ClientGraph:
        """Edge (i,j) survives this round w.p. p(d_ij); the surviving
        adjacency is re-patched connected so zones/walks stay well
        defined. Draws the upper triangle only (symmetric outcome)."""
        if not self.cfg.dropout:
            return graph
        if isinstance(graph, NeighborGraph):
            return self._apply_dropouts_sparse(graph, rng)
        d2, p = self._geometry(graph)
        u = rng.uniform(size=p.shape)
        u = np.triu(u, 1)
        u = u + u.T                      # symmetric uniforms
        adj = graph.adjacency & (u < p)
        adj = patch_connected(adj, d2)
        out = ClientGraph(adjacency=adj, positions=graph.positions)
        seed_sq_dist_cache(out, d2)      # same positions → same distances
        return out

    def apply_dropouts_batch(self, graphs: list[ClientGraph],
                             rng: np.random.Generator) -> list[ClientGraph]:
        """Batched :meth:`apply_dropouts` for a whole rollout window.

        Samples the full (R, n, n) uniform tensor in one draw (bit-
        identical to R sequential (n, n) draws), applies every round's
        Bernoulli edge survival elementwise, then checks connectivity of
        all R survivors with one batched frontier expansion — only the
        rounds that actually disconnect pay the per-graph component
        patch. Link success probabilities are computed once per distinct
        base graph (consecutive rounds share the mobility graph under
        ``static_regen``).
        """
        if not self.cfg.dropout:
            return list(graphs)
        rounds = len(graphs)
        if rounds == 0:
            return []
        if isinstance(graphs[0], NeighborGraph):
            return self._apply_dropouts_batch_sparse(graphs, rng)
        n = graphs[0].n
        u = rng.uniform(size=(rounds, n, n))
        u = np.triu(u, 1)
        u = u + u.transpose(0, 2, 1)     # symmetric uniforms, per round
        # Geometry once per *distinct* base graph (static_regen shares
        # one graph per regen epoch; smooth mobility has one per round),
        # with the success-probability curve evaluated over the whole
        # distinct-graph stack in a single vectorized pass.
        runs: list[tuple[int, int, ClientGraph]] = []
        start = 0
        while start < rounds:
            g = graphs[start]
            stop = start + 1
            while stop < rounds and graphs[stop] is g:
                stop += 1
            runs.append((start, stop, g))
            start = stop
        d2_stack = np.stack([graph_sq_dists(g) for _, _, g in runs])
        adj_stack = np.stack([g.adjacency for _, _, g in runs])
        finite = np.where(np.isfinite(d2_stack), d2_stack, 0.0)
        p_stack = np.where(adj_stack,
                           self.success_probability_sq(finite), 0.0)
        ri = np.repeat(np.arange(len(runs)),
                       [b - a for a, b, _ in runs])
        surv = adj_stack[ri] & (u < p_stack[ri])
        d2s = [d2_stack[j] for j in ri]
        return graphs_from_stack(surv, d2s,
                                 [g.positions for g in graphs])

    def _apply_dropouts_batch_sparse(self, graphs: list[NeighborGraph],
                                     rng: np.random.Generator
                                     ) -> list[NeighborGraph]:
        """Sparse lane of :meth:`apply_dropouts_batch`: one uniform per
        undirected edge, drawn round-by-round — the generator fills
        sequentially, so this equals one whole-window draw bit-for-bit
        while never materializing a window-sized edge tensor (the
        windowed peak stays O(n·k) + the survivors themselves).
        :meth:`_edge_geometry`'s last-graph cache already serves the
        window's run-length structure (``static_regen`` repeats one
        graph per regen epoch; smooth mobility is one per round)."""
        return [self._apply_dropouts_sparse(g, rng) for g in graphs]


class CommModel:
    """Price one zone round in (bytes, latency_s, energy_j).

    Per transmission of ``b`` bytes over distance ``d``:
      latency  = base_latency_s + b / bandwidth
      E_tx     = b · (e_elec + e_amp · d^η)
      E_rx     = b · e_elec
    scaled by expected transmission count 1/p(d) (capped by the link
    model's ``min_success``; p ≡ 1 when no link model is attached).
    The broadcast is one transmission sized to the farthest member
    (latency takes the worst link's retry count); uploads are
    sequential TDMA slots, so their latencies add.
    """

    def __init__(self, cfg: CommConfig, link: LinkModel | None = None,
                 path_loss_exp: float = 3.0):
        self.cfg = cfg
        self.link = link
        self.eta = link.cfg.path_loss_exp if link is not None \
            else path_loss_exp

    def _link_costs(self, d: np.ndarray, retries: np.ndarray,
                    payload: float
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-link (latency, tx energy, rx energy) of one ``payload``-
        byte transmission over distance ``d``, scaled by the expected
        transmission count ``retries`` — the one radio-cost formula
        shared by zone pricing and base-station pricing."""
        c = self.cfg
        t = (c.base_latency_s + payload / c.bandwidth_bytes_per_s) * retries
        e_tx = payload * (c.e_elec_j_per_byte
                          + c.e_amp_j_per_byte * d ** self.eta) * retries
        e_rx = payload * c.e_elec_j_per_byte * retries
        return t, e_tx, e_rx

    def _retries(self, d: np.ndarray, base: np.ndarray) -> np.ndarray:
        """Expected transmissions per link: base/p(d) under the link
        model (capped by its ``min_success``), ``base`` without one."""
        if self.link is None:
            return base
        return base / self.link.success_probability(d)

    def price_rounds(self, pos_ik: np.ndarray, mem_pos: np.ndarray,
                     mem_mask: np.ndarray, payload_bytes: int
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized pricing of R zone rounds in one pass.

        pos_ik (R, 2) server positions, mem_pos (R, Z, 2) padded member
        positions, mem_mask (R, Z) ∈ {0,1} live *non-self* members.
        Returns (latency_s (R,), energy_j (R,)).

        Broadcast and uploads traverse the same links, so one per-link
        evaluation prices both directions: broadcast — one TX sized to
        the farthest member, every member receives, the worst link
        gates the latency; uploads — one TX per member, sequential
        TDMA slots (sum). Rounds with no live members (solo zone: the
        walker updates in place) price to zero. This single code path
        serves both the eager per-round engine (R = 1) and whole
        precomputed schedules, so the engines price identically.
        """
        payload = float(payload_bytes)
        d = np.linalg.norm(mem_pos - pos_ik[:, None, :], axis=2)  # (R, Z)
        m = np.asarray(mem_mask, dtype=np.float64)
        t, e_tx, e_rx = self._link_costs(d, self._retries(d, m), payload)
        latency = t.max(axis=1) + t.sum(axis=1)
        energy = (e_tx.max(axis=1) + e_rx.sum(axis=1)      # broadcast
                  + e_tx.sum(axis=1) + e_rx.sum(axis=1))   # uploads
        return latency, energy

    def price_schedule(self, graphs, clients: np.ndarray, idx: np.ndarray,
                       mask: np.ndarray, payload_bytes: int
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Price a whole precomputed schedule: R per-round position
        gathers, then one vectorized :meth:`price_rounds` pass."""
        clients = np.asarray(clients)
        pos_ik = np.stack([g.positions[int(c)]
                           for g, c in zip(graphs, clients)])
        mem_pos = np.stack([g.positions[i]
                            for g, i in zip(graphs, idx)])
        mem_mask = np.asarray(mask) * (idx != clients[:, None])
        return self.price_rounds(pos_ik, mem_pos, mem_mask, payload_bytes)

    def price_fleet_schedule(self, graphs, clients: np.ndarray,
                             idx: np.ndarray, mask: np.ndarray,
                             payload_bytes: int
                             ) -> tuple[np.ndarray, np.ndarray]:
        """Per-walker pricing of a simultaneous-fleet window.

        clients (R, K) walker positions, idx (R, K, Z) / mask (R, K, Z)
        padded zones. Each walker's zone is an independent short-range
        exchange, so the walker axis flattens into the round axis and
        one :meth:`price_schedule` pass prices all R·K zones; returns
        ((R, K), (R, K)) latency/energy columns for the caller to
        aggregate (wall latency = max over walkers — the zones are
        served in parallel — and energy = sum).
        """
        clients = np.asarray(clients)
        rounds, k_walkers = clients.shape
        graphs_f = [g for g in graphs for _ in range(k_walkers)]
        lat, en = self.price_schedule(
            graphs_f, clients.reshape(-1),
            np.asarray(idx).reshape(rounds * k_walkers, -1),
            np.asarray(mask).reshape(rounds * k_walkers, -1),
            payload_bytes)
        return (lat.reshape(rounds, k_walkers),
                en.reshape(rounds, k_walkers))

    def price_round(self, graph: ClientGraph, i_k: int, idx: np.ndarray,
                    mask: np.ndarray, payload_bytes: int
                    ) -> tuple[float, float]:
        """Latency and energy for one zone round (deterministic)."""
        lat, en = self.price_schedule(
            [graph], np.asarray([i_k]), np.asarray(idx)[None],
            np.asarray(mask)[None], payload_bytes)
        return float(lat[0]), float(en[0])

    def price_star_round(self, positions: np.ndarray, members: np.ndarray,
                         payload_bytes: int) -> tuple[float, float]:
        """Infrastructure baseline pricing: every selected client
        exchanges one model copy each way with a base station at the
        field center (0.5, 0.5). Used by the FedAvg-family trainers so
        wireless costs are comparable across algorithms."""
        members = np.asarray(members)
        if len(members) == 0:
            return 0.0, 0.0
        payload = float(payload_bytes)
        d = np.linalg.norm(positions[members] - 0.5, axis=1)
        t, e_tx, e_rx = self._link_costs(
            d, self._retries(d, np.ones_like(d)), payload)
        # Download + upload per client; uplink slots shared (sum), the
        # broadcast downlink gated by the worst client.
        latency = float(t.max() + t.sum())
        energy = float(2.0 * (e_tx.sum() + e_rx.sum()))
        return latency, energy
