"""The mobile server's random walk and the precomputed zone schedule.

The unbiased degree chain of ``repro/core/markov.py`` as its own numpy
copy: [P]_ij = 1/deg(i) for j ~ i (paper §5). Zone planning and the
per-round seed draws consume the shared host RNG exactly as the
reference does, so the same seed gives the same walk, zones and seeds.

Each round's seed becomes the reference's threefry key,
``PRNGKey(seed)``, whose words the schedules carry (``core/prng.py``
draws from them).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .graph import ClientGraph


def degree_transition_matrix(graph: ClientGraph) -> np.ndarray:
    """[P]_{ij} = 1/deg(i) for j in N(i)\\{i}; stationary π_i ∝ deg(i)."""
    adj = graph.adjacency.astype(np.float64)
    deg = adj.sum(axis=1, keepdims=True)
    return adj / np.maximum(deg, 1.0)


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
    def transition_row(graph: ClientGraph, i: int) -> np.ndarray:
        """Row i of P(k), bit-identical to ``degree_transition_matrix``'s
        row (0/1 sums are exact, one division either way). The degree
        chain has no self-loop; an isolated node's all-zero row keeps
        its divisor clamped at 1."""
        row = graph.adjacency[i].astype(np.float64)
        return row / max(row.sum(), 1.0)

    def step(self, graph: ClientGraph) -> int:
        """One random-walk move: i_{k+1} ~ [P(k)]_{i_k, ·} (Eq. 2)."""
        assert self.position is not None, "call reset() first"
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
    """

    idx: np.ndarray
    mask: np.ndarray
    n_i: np.ndarray
    keys: np.ndarray
    clients: np.ndarray
    active: np.ndarray

    @property
    def rounds(self) -> int:
        return int(self.idx.shape[0])

    @property
    def zone_size(self) -> int:
        return int(self.idx.shape[1])


def plan_zone_round(graph: ClientGraph, i_k: int, zone_size: int,
                    rng: np.random.Generator
                    ) -> tuple[np.ndarray, np.ndarray, int]:
    """Form the active zone S(i_k) ⊆ N(i_k) (Eq. 31 subset): i_k plus, when
    N(i_k) is larger than ``zone_size``, random neighbors drawn from
    ``rng``. Returns (idx (Z,), mask (Z,), n_i)."""
    zone = graph.neighborhood(i_k)
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


def _plan_rounds(graphs, positions, zone_size, rng):
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
            graphs[k], int(positions[k]), zone_size, rng)
        active[k] = int(mask[k].sum())
        seeds[k] = round_key_seed(rng)
    return idx, mask, n_i, seeds, active


def zone_schedule(dyn_graph, walker: RandomWalkServer, rounds: int,
                  zone_size: int, rng: np.random.Generator,
                  *, start_round: int = 0) -> ZoneSchedule:
    """Precompute ``rounds`` zone rounds: graphs (regeneration epochs
    included), walk positions, padded zones and seeds. Advances
    ``dyn_graph``, ``walker`` and ``rng`` exactly as the same number of
    eager rounds would, so consecutive chunks compose into one run."""
    first = start_round == 0
    graphs = dyn_graph.schedule(rounds, include_current=first)
    positions = walker.walk_schedule(graphs, advance_first=not first)
    idx, mask, n_i, seeds, active = _plan_rounds(
        graphs, positions, zone_size, rng)
    return ZoneSchedule(idx=idx, mask=mask, n_i=n_i, keys=round_keys(seeds),
                        clients=positions.astype(np.int32), active=active)


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
    clients/n_i/active are (R, K).
    """

    walker: np.ndarray | None = None
    sync: np.ndarray | None = None
    mode: str = "roundrobin"

    @property
    def zone_size(self) -> int:
        return int(self.idx.shape[-1])


def plan_fleet_zone_round(graph: ClientGraph, positions: np.ndarray,
                          zone_size: int, rng: np.random.Generator
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """K zone plans for one simultaneous wall step: (idx (K, Z), mask
    (K, Z), n_i (K,)).

    Walkers plan in index order and a client claimed by an earlier walker
    is left out of later walkers' zones (lowest walker index wins), so
    the K zones are pairwise disjoint and the round's scatter-add has no
    duplicate live ids. A walker whose own position was already claimed
    serves whatever unclaimed neighbors remain, possibly none: an
    all-padding row, the walker idles."""
    k_walkers = len(positions)
    idx = np.zeros((k_walkers, zone_size), np.int32)
    mask = np.zeros((k_walkers, zone_size), np.float32)
    n_i = np.zeros((k_walkers,), np.float32)
    taken = np.zeros(graph.n, dtype=bool)
    for k, i_k in enumerate(positions):
        i_k = int(i_k)
        zone = graph.neighborhood(i_k)
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
                        sync_every: int = 20, mode: str = "roundrobin"
                        ) -> FleetZoneSchedule:
    """Precompute ``rounds`` fleet rounds: active walker, per-walker walk
    positions, zone plan(s), rendezvous (sync) mask and seeds. Consumes
    ``dyn_graph``, each walker's RNG and the shared ``rng`` exactly as
    the eager fleet rounds would, so chunks compose.

    Round-robin: walker ``(start_round + r) % K`` serves round r; for the
    first K rounds of a run the graph holds still and nobody moves
    (every vehicle starts parked at a client), then the graph advances
    per round and the active walker steps.

    Simultaneous: every walker moves every wall step and
    :func:`plan_fleet_zone_round` forms K disjoint zones per round."""
    k_walkers = len(walkers)
    if mode == "roundrobin":
        lead = min(max(k_walkers - start_round, 0), rounds)
    elif mode == "simultaneous":
        lead = 1 if start_round == 0 else 0
    else:
        raise ValueError(
            f"mode must be roundrobin|simultaneous, got {mode!r}")
    parked_graphs = [dyn_graph.current()] * lead   # before it advances
    stepped = (dyn_graph.schedule(rounds - lead, include_current=False)
               if rounds > lead else [])
    graphs = parked_graphs + stepped
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
            graphs, positions, zone_size, rng)
        return FleetZoneSchedule(
            idx=idx, mask=mask, n_i=n_i, keys=round_keys(seeds),
            clients=positions.astype(np.int32), active=active,
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
            graphs[r], positions[r], z, rng)
        seeds[r] = round_key_seed(rng)
    return FleetZoneSchedule(
        idx=idx, mask=mask, n_i=n_i, keys=round_keys(seeds),
        clients=positions.astype(np.int32),
        active=mask.sum(axis=2).astype(np.int32), sync=sync, mode=mode)


def _sync_mask(start_round: int, rounds: int, sync_every: int) -> np.ndarray:
    """(R,) float32 rendezvous mask: 1.0 after rounds where
    ``(rnd + 1) % sync_every == 0``, the eager fleet's trigger."""
    rs = start_round + np.arange(rounds)
    return ((rs + 1) % max(int(sync_every), 1) == 0).astype(np.float32)
