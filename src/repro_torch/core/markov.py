"""The mobile server's random walk and the precomputed zone schedule.

The unbiased degree chain of ``repro/core/markov.py`` as its own numpy
copy: [P]_ij = 1/deg(i) for j ~ i (paper §5), on either graph backend,
with the chain's spectral diagnostics (π, σ(P), λ₂, the mixing time of
Eq. 6). Zone planning and the per-round seed draws consume the shared
host RNG exactly as the reference does, so the same seed gives the same
walk, zones and seeds. A scenario (``scenarios/``) adds its churn masks
to zone planning and prices each round (``latency_s``, ``energy_j``).

Each round's seed becomes the reference's threefry key,
``PRNGKey(seed)``, whose words the schedules carry (``core/prng.py``
draws from them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from .graph import ClientGraph, NeighborGraph


def degree_transition_matrix(graph: ClientGraph) -> np.ndarray:
    """[P]_{ij} = 1/deg(i) for j in N(i)\\{i}; stationary π_i ∝ deg(i)."""
    adj = graph.adjacency.astype(np.float64)
    deg = adj.sum(axis=1, keepdims=True)
    return adj / np.maximum(deg, 1.0)


def stationary_distribution(p: np.ndarray, tol: float = 1e-12) -> np.ndarray:
    """π with πᵀP = πᵀ, via power iteration on Pᵀ."""
    n = p.shape[0]
    pi = np.full(n, 1.0 / n)
    for _ in range(100_000):
        nxt = pi @ p
        if np.abs(nxt - pi).max() < tol:
            pi = nxt
            break
        pi = nxt
    return pi / pi.sum()


def sigma(p: np.ndarray) -> float:
    """σ(P) := sup { ||fᵀP|| / ||f|| : fᵀ1 = 0 }  (paper Eq. 6): the
    largest singular value of Pᵀ restricted to 1⊥."""
    n = p.shape[0]
    q, _ = np.linalg.qr(np.concatenate([np.ones((n, 1)) / math.sqrt(n),
                                        np.eye(n)[:, : n - 1]], axis=1))
    basis = q[:, 1:]  # (n, n-1), orthonormal, ⊥ 1
    m = basis.T @ p @ p.T @ basis
    ev = np.linalg.eigvalsh(m)
    return float(np.sqrt(max(ev.max(), 0.0)))


def lambda2(p: np.ndarray) -> float:
    """Second-largest eigenvalue modulus (reversible-chain rate, Eq. 30)."""
    ev = np.linalg.eigvals(p)
    ev = np.sort(np.abs(ev))[::-1]
    return float(ev[1]) if len(ev) > 1 else 0.0


def mixing_time(p: np.ndarray, delta: float = 0.5,
                pi: np.ndarray | None = None) -> int:
    """τ(δ) = ceil( ln(√2/(δ π_*)) / (1 − σ(P)) )   (paper Eq. 6)."""
    if pi is None:
        pi = stationary_distribution(p)
    pi_star = float(pi.min())
    s = sigma(p)
    if s >= 1.0 - 1e-12:
        return 2**31 - 1  # non-ergodic chain: infinite mixing time
    return int(math.ceil(math.log(math.sqrt(2.0) / (delta * pi_star))
                         / (1.0 - s)))


def p_max_envelope(ps: list[np.ndarray]) -> np.ndarray:
    """Eq. (5): elementwise max over the dynamic chain's matrices P(k)."""
    env = ps[0].copy()
    for p in ps[1:]:
        np.maximum(env, p, out=env)
    return env


def verify_assumption_3_1(p: np.ndarray, delta: float = 0.5) -> dict:
    """Empirically verify the mixing inequality Eq. (3)/(4) for τ(δ)."""
    pi = stationary_distribution(p)
    tau = mixing_time(p, delta, pi)
    if tau >= 2**30:  # non-ergodic (e.g. periodic bipartite chain)
        return {"tau": tau, "holds": False, "max_dev": float("inf"),
                "pi_star": float(pi.min()), "sigma": sigma(p),
                "lambda2": lambda2(p)}
    pt = np.linalg.matrix_power(p, tau)
    dev = np.abs(pt - pi[None, :]).max()
    return {
        "tau": tau,
        "pi_star": float(pi.min()),
        "sigma": sigma(p),
        "lambda2": lambda2(p),
        "max_dev": float(dev),
        "holds": bool(dev <= delta * pi.min() + 1e-9),
    }


class RandomWalkServer:
    """The mobile server walking the client graph on the degree chain
    (Eq. 2). Host-side control plane: the visited sequence (i_k) decides
    which zone each round updates."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.position: int | None = None
        self.visit_counts: np.ndarray | None = None
        self.history: list[int] = []
        self._n_seen = 0
        self._cover_step: int | None = None

    def reset(self, graph: ClientGraph, start: int | None = None) -> int:
        self.visit_counts = np.zeros(graph.n, dtype=np.int64)
        self.history = []
        self._n_seen = 0
        self._cover_step = None
        self.position = (int(self._rng.integers(graph.n))
                         if start is None else int(start))
        self._record_visit(self.position, graph.n)
        return self.position

    def _record_visit(self, i: int, n: int) -> None:
        if self.visit_counts[i] == 0:
            self._n_seen += 1
            if self._n_seen == n and self._cover_step is None:
                self._cover_step = len(self.history)
        self.visit_counts[i] += 1
        self.history.append(i)

    @staticmethod
    def transition_row(graph: ClientGraph | NeighborGraph,
                       i: int) -> np.ndarray:
        """Row i of P(k), bit-identical to ``degree_transition_matrix``'s
        row (0/1 sums are exact, one division either way). Only the O(n)
        row is built, never the matrix: under link dropout every round
        has a fresh graph. The degree chain has no self-loop; an
        isolated node's all-zero row keeps its divisor clamped at 1."""
        if isinstance(graph, NeighborGraph):
            nbrs = graph.neighbors(i)
            row = np.zeros(graph.n)
            row[nbrs] = 1.0 / max(float(len(nbrs)), 1.0)
            return row
        row = graph.adjacency[i].astype(np.float64)
        return row / max(row.sum(), 1.0)

    def _sample_sparse(self, graph: NeighborGraph, u: float) -> int:
        """Map one uniform through row ``position``'s CDF over its
        neighbors (ascending), as the reference's sparse walk does: the
        O(deg) row of a neighbor-list graph, never a length-n one."""
        nbrs = graph.neighbors(self.position)
        probs = np.full(len(nbrs), 1.0) / max(float(len(nbrs)), 1.0)
        cdf = probs.cumsum()
        cdf /= cdf[-1]
        j = int(np.searchsorted(cdf, u, side="right"))
        return int(nbrs[min(j, len(nbrs) - 1)])

    def step(self, graph: ClientGraph | NeighborGraph) -> int:
        """One random-walk move: i_{k+1} ~ [P(k)]_{i_k, ·} (Eq. 2). A
        neighbor-list graph draws one uniform (``Generator.random``), a
        dense one ``Generator.choice`` over the row, each as the
        reference's backend does."""
        assert self.position is not None, "call reset() first"
        if isinstance(graph, NeighborGraph):
            self.position = self._sample_sparse(graph, self._rng.random())
        else:
            row = self.transition_row(graph, self.position)
            self.position = int(self._rng.choice(graph.n, p=row))
        self._record_visit(self.position, graph.n)
        return self.position

    def hitting_time(self) -> int | None:
        """Steps until every client was first visited, or None."""
        return None if self.visit_counts is None else self._cover_step

    def walk_schedule(self, graphs: Sequence[ClientGraph],
                      *, advance_first: bool = True) -> np.ndarray:
        """The visited sequence over a graph schedule, consuming the walk
        RNG as per-round :meth:`step` calls would. ``advance_first=False``
        keeps the first entry at the current position (round 0)."""
        positions = np.empty(len(graphs), dtype=np.int64)
        for k, graph in enumerate(graphs):
            if k == 0 and not advance_first:
                assert self.position is not None, "call reset() first"
                positions[k] = self.position
            else:
                positions[k] = self.step(graph)
        return positions


def round_key_seed(rng: np.random.Generator) -> int:
    """One round's key seed from the shared simulation RNG — the same
    draw the reference turns into its round key."""
    return int(rng.integers(2**31 - 1))


def round_keys(seeds) -> np.ndarray:
    """``PRNGKey(seed)`` of each seed as int64 words ``(..., 2)``: the
    seed's high and low 32 bits (``[0, seed]`` for the host RNG's
    seeds)."""
    seeds = np.asarray(seeds, dtype=np.int64)
    return np.stack([(seeds >> 32) & 0xFFFFFFFF, seeds & 0xFFFFFFFF],
                    axis=-1)


@dataclasses.dataclass(frozen=True)
class ZoneSchedule:
    """R precomputed zone rounds as fixed-shape host arrays.

    idx:     (R, Z) int32 — active-client ids, padded with 0.
    mask:    (R, Z) float32 — 1 for live slots, 0 for padding.
    n_i:     (R,) float32 — |N(i_k)| zone sizes (pre-subsampling).
    keys:    (R, 2) int64 — per-round keys, the words of the reference's
             ``PRNGKey(seed)``.
    clients: (R,) int32 — the visited client i_k per round.
    active:  (R,) int32 — number of live slots per round (≤ Z).

    A schedule priced by a scenario's comm model carries two more host
    columns, which never reach the device:

    latency_s: (R,) float64 — expected round latency, or None.
    energy_j:  (R,) float64 — expected round radio energy, or None.
    """

    idx: np.ndarray
    mask: np.ndarray
    n_i: np.ndarray
    keys: np.ndarray
    clients: np.ndarray
    active: np.ndarray
    latency_s: np.ndarray | None = None
    energy_j: np.ndarray | None = None

    @property
    def rounds(self) -> int:
        return int(self.idx.shape[0])

    @property
    def zone_size(self) -> int:
        return int(self.idx.shape[1])


def plan_zone_round(graph, i_k: int, zone_size: int,
                    rng: np.random.Generator,
                    avail: np.ndarray | None = None
                    ) -> tuple[np.ndarray, np.ndarray, int]:
    """Form the active zone S(i_k) ⊆ N(i_k) (Eq. 31 subset): i_k plus, when
    N(i_k) is larger than ``zone_size``, random neighbors drawn from
    ``rng``. Returns (idx (Z,), mask (Z,), n_i).

    ``avail`` is an optional (n,) bool availability mask (a scenario's
    churn): offline neighbors leave the zone before subsampling, and the
    visited client i_k always stays (the server is at its location)."""
    zone = graph.neighborhood(i_k)
    if avail is not None:
        zone = zone[avail[zone] | (zone == i_k)]
    n_i = len(zone)
    if n_i > zone_size:
        others = zone[zone != i_k]
        pick = rng.choice(others, size=zone_size - 1, replace=False)
        active = np.concatenate([[i_k], pick])
    else:
        active = zone
    mask = np.zeros(zone_size, np.float32)
    mask[: len(active)] = 1.0
    idx = np.zeros(zone_size, np.int32)
    idx[: len(active)] = active
    return idx, mask, n_i


def _plan_rounds(graphs, positions, zone_size, rng, avails=None):
    """Zone membership + seeds per round, interleaving the subsample and
    seed draws in round order as the eager engine does."""
    rounds = len(graphs)
    idx = np.zeros((rounds, zone_size), np.int32)
    mask = np.zeros((rounds, zone_size), np.float32)
    n_i = np.zeros((rounds,), np.float32)
    seeds = np.zeros((rounds,), np.int64)
    active = np.zeros((rounds,), np.int32)
    for k in range(rounds):
        idx[k], mask[k], n_i[k] = plan_zone_round(
            graphs[k], int(positions[k]), zone_size, rng,
            avail=None if avails is None else avails[k])
        active[k] = int(mask[k].sum())
        seeds[k] = round_key_seed(rng)
    return idx, mask, n_i, seeds, active


def _pop_avails(dyn_graph):
    """The (R, n) availability masks of ``dyn_graph``'s last
    ``schedule`` call, or None (no churn, or a plain ``DynamicGraph``)."""
    pop = getattr(dyn_graph, "pop_avail_trace", None)
    return pop() if pop is not None else None


def zone_schedule(dyn_graph, walker: RandomWalkServer, rounds: int,
                  zone_size: int, rng: np.random.Generator,
                  *, start_round: int = 0, price=None) -> ZoneSchedule:
    """Precompute ``rounds`` zone rounds: graphs (regeneration epochs
    included), walk positions, padded zones and seeds. Advances
    ``dyn_graph``, ``walker`` and ``rng`` exactly as the same number of
    eager rounds would, so consecutive chunks compose into one run.

    ``dyn_graph`` is a ``DynamicGraph`` or a ``scenarios.Scenario``,
    whose churn masks feed zone planning. ``price(graphs, clients, idx,
    mask) -> ((R,), (R,))`` prices the window (no RNG) into the
    ``latency_s`` and ``energy_j`` columns."""
    first = start_round == 0
    graphs = dyn_graph.schedule(rounds, include_current=first)
    avails = _pop_avails(dyn_graph)
    positions = walker.walk_schedule(graphs, advance_first=not first)
    idx, mask, n_i, seeds, active = _plan_rounds(
        graphs, positions, zone_size, rng, avails)
    latency = energy = None
    if price is not None:
        latency, energy = price(graphs, positions, idx, mask)
    return ZoneSchedule(idx=idx, mask=mask, n_i=n_i, keys=round_keys(seeds),
                        clients=positions.astype(np.int32), active=active,
                        latency_s=latency, energy_j=energy)


# ---------------------------------------------------------------------------
# Fleet schedules: K mobile servers in one precomputed window. Round-robin
# mode serves one walker's zone per round (the walkers take turns);
# simultaneous mode moves all K walkers every wall step and serves K
# disjoint zones at once.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetZoneSchedule(ZoneSchedule):
    """R precomputed fleet rounds (see :class:`ZoneSchedule`).

    Round-robin mode keeps the base-class shapes and adds:

    walker: (R,) int32 — the active walker per round, or None.
    sync:   (R,) float32 — 1.0 where a rendezvous (token averaging)
            follows the round, 0.0 otherwise.

    Simultaneous mode gains a walker axis: idx/mask are (R, K, Z) and
    clients/n_i/active are (R, K). Its latency/energy columns are the
    (R,) wall-step aggregates (latency the max over walkers, whose zones
    are served in parallel; energy the sum), with the per-walker (R, K)
    prices in ``latency_s_walkers``/``energy_j_walkers``.
    """

    walker: np.ndarray | None = None
    sync: np.ndarray | None = None
    latency_s_walkers: np.ndarray | None = None
    energy_j_walkers: np.ndarray | None = None
    mode: str = "roundrobin"

    @property
    def zone_size(self) -> int:
        return int(self.idx.shape[-1])


def plan_fleet_zone_round(graph, positions: np.ndarray,
                          zone_size: int, rng: np.random.Generator,
                          avail: np.ndarray | None = None
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """K zone plans for one simultaneous wall step: (idx (K, Z), mask
    (K, Z), n_i (K,)).

    Walkers plan in index order and a client claimed by an earlier walker
    is left out of later walkers' zones (lowest walker index wins), so
    the K zones are pairwise disjoint and the round's scatter-add has no
    duplicate live ids. A walker whose own position was already claimed
    serves whatever unclaimed neighbors remain, possibly none: an
    all-padding row, the walker idles. ``avail`` drops offline
    neighbors as in :func:`plan_zone_round`; a walker's own position
    always stays unless an earlier walker claimed it."""
    k_walkers = len(positions)
    idx = np.zeros((k_walkers, zone_size), np.int32)
    mask = np.zeros((k_walkers, zone_size), np.float32)
    n_i = np.zeros((k_walkers,), np.float32)
    taken = np.zeros(graph.n, dtype=bool)
    for k, i_k in enumerate(positions):
        i_k = int(i_k)
        zone = graph.neighborhood(i_k)
        if avail is not None:
            zone = zone[avail[zone] | (zone == i_k)]
        zone = zone[~taken[zone]]
        n_i[k] = len(zone)
        if len(zone) > zone_size:
            if taken[i_k]:
                active = rng.choice(zone, size=zone_size, replace=False)
            else:
                others = zone[zone != i_k]
                pick = rng.choice(others, size=zone_size - 1, replace=False)
                active = np.concatenate([[i_k], pick])
        else:
            active = zone
        mask[k, : len(active)] = 1.0
        idx[k, : len(active)] = active
        taken[active] = True
    return idx, mask, n_i


def fleet_zone_schedule(dyn_graph, walkers: Sequence[RandomWalkServer],
                        rounds: int, zone_size: int,
                        rng: np.random.Generator, *, start_round: int = 0,
                        sync_every: int = 20, mode: str = "roundrobin",
                        price=None, price_fleet=None) -> FleetZoneSchedule:
    """Precompute ``rounds`` fleet rounds: active walker, per-walker walk
    positions, zone plan(s), rendezvous (sync) mask, seeds and prices.
    Consumes ``dyn_graph``, each walker's RNG and the shared ``rng``
    exactly as the eager fleet rounds would, so chunks compose.

    Round-robin: walker ``(start_round + r) % K`` serves round r; for the
    first K rounds of a run the graph holds still and nobody moves
    (every vehicle starts parked at a client), then the graph advances
    per round and the active walker steps. ``price`` prices each round's
    zone as :func:`zone_schedule`'s does.

    Simultaneous: every walker moves every wall step and
    :func:`plan_fleet_zone_round` forms K disjoint zones per round.
    ``price_fleet(graphs, clients (R, K), idx, mask) -> ((R, K), (R, K))``
    prices each walker's zone. Parked rounds plan against the current
    availability mask, stepped ones against the window's."""
    k_walkers = len(walkers)
    if mode == "roundrobin":
        lead = min(max(k_walkers - start_round, 0), rounds)
    elif mode == "simultaneous":
        lead = 1 if start_round == 0 else 0
    else:
        raise ValueError(
            f"mode must be roundrobin|simultaneous, got {mode!r}")
    avail_fn = getattr(dyn_graph, "availability", None)
    cur_avail = avail_fn() if avail_fn is not None else None
    parked_graphs = [dyn_graph.current()] * lead   # before it advances
    stepped, trace = [], None
    if rounds > lead:
        stepped = dyn_graph.schedule(rounds - lead, include_current=False)
        trace = _pop_avails(dyn_graph)
    graphs = parked_graphs + stepped
    if cur_avail is None and trace is None:
        avails = None
    else:
        avails = [cur_avail] * lead + (list(trace) if trace is not None
                                       else [None] * len(stepped))
    sync = _sync_mask(start_round, rounds, sync_every)

    if mode == "roundrobin":
        active_walker = ((start_round + np.arange(rounds))
                         % k_walkers).astype(np.int32)
        positions = np.empty((rounds,), np.int64)
        for k, w in enumerate(walkers):
            # Each walker's RNG is its own, so grouping the rounds by
            # walker replays the per-round order exactly.
            mine = np.flatnonzero(active_walker == k)
            parked = mine[mine < lead]
            if len(parked):
                assert w.position is not None, "call reset() first"
                positions[parked] = w.position
            moving = mine[mine >= lead]
            if len(moving):
                positions[moving] = w.walk_schedule(
                    [graphs[r] for r in moving], advance_first=True)
        idx, mask, n_i, seeds, active = _plan_rounds(
            graphs, positions, zone_size, rng, avails)
        latency = energy = None
        if price is not None:
            latency, energy = price(graphs, positions, idx, mask)
        return FleetZoneSchedule(
            idx=idx, mask=mask, n_i=n_i, keys=round_keys(seeds),
            clients=positions.astype(np.int32), active=active,
            latency_s=latency, energy_j=energy,
            walker=active_walker, sync=sync, mode=mode)

    positions = np.empty((rounds, k_walkers), np.int64)
    for k, w in enumerate(walkers):
        if lead:
            assert w.position is not None, "call reset() first"
            positions[0, k] = w.position
        if rounds > lead:
            positions[lead:, k] = w.walk_schedule(stepped,
                                                  advance_first=True)
    z = zone_size
    idx = np.zeros((rounds, k_walkers, z), np.int32)
    mask = np.zeros((rounds, k_walkers, z), np.float32)
    n_i = np.zeros((rounds, k_walkers), np.float32)
    seeds = np.zeros((rounds,), np.int64)
    for r in range(rounds):
        idx[r], mask[r], n_i[r] = plan_fleet_zone_round(
            graphs[r], positions[r], z, rng,
            avail=None if avails is None else avails[r])
        seeds[r] = round_key_seed(rng)
    latency = energy = lat_kw = en_kw = None
    if price_fleet is not None:
        lat_kw, en_kw = price_fleet(graphs, positions, idx, mask)
        latency, energy = lat_kw.max(axis=1), en_kw.sum(axis=1)
    return FleetZoneSchedule(
        idx=idx, mask=mask, n_i=n_i, keys=round_keys(seeds),
        clients=positions.astype(np.int32),
        active=mask.sum(axis=2).astype(np.int32),
        latency_s=latency, energy_j=energy, sync=sync,
        latency_s_walkers=lat_kw, energy_j_walkers=en_kw, mode=mode)


def _sync_mask(start_round: int, rounds: int, sync_every: int) -> np.ndarray:
    """(R,) float32 rendezvous mask: 1.0 after rounds where
    ``(rnd + 1) % sync_every == 0``, the eager fleet's trigger."""
    rs = start_round + np.arange(rounds)
    return ((rs + 1) % max(int(sync_every), 1) == 0).astype(np.float32)
