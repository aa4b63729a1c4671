"""The mobile server's random walk and the precomputed zone schedule.

The chains of ``repro/core/markov.py`` as its own numpy copy, on either
graph backend: the degree chain [P]_ij = 1/deg(i) for j ~ i (paper §5),
the Metropolis chain (uniform π) and the importance-biased walk policies
(``staleness``, ``label_skew``: MH chains targeting π ∝ w, each visit
recording its Walk-for-Learning weight 1/(n·π_i), the schedules' ``iw``
column; ``docs/walks.md``), with the chains' spectral diagnostics (π,
σ(P), λ₂, the mixing time of Eq. 6). Zone planning and the per-round seed draws consume the shared
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
import weakref
from typing import Any, Sequence

import numpy as np

from .graph import ClientGraph, NeighborGraph


def degree_transition_matrix(graph: ClientGraph) -> np.ndarray:
    """[P]_{ij} = 1/deg(i) for j in N(i)\\{i}; stationary π_i ∝ deg(i)."""
    adj = graph.adjacency.astype(np.float64)
    deg = adj.sum(axis=1, keepdims=True)
    return adj / np.maximum(deg, 1.0)


def metropolis_transition_matrix(graph: ClientGraph) -> np.ndarray:
    """Metropolis-Hastings weights, uniform stationary distribution:
    P_ij = min(1/deg(i), 1/deg(j)) for j ~ i, the self-loop the rest."""
    adj = graph.adjacency.astype(np.float64)
    deg = adj.sum(axis=1)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    p = adj * np.minimum(inv[:, None], inv[None, :])
    # The rounded terms can sum a hair above 1; a −2⁻⁵² self-loop would
    # poison rng.choice, so clamp (the sparse and biased rows do too).
    np.fill_diagonal(p, np.maximum(1.0 - p.sum(axis=1), 0.0))
    return p


def biased_transition_matrix(graph: ClientGraph,
                             weights: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings chain targeting π ∝ ``weights``:
    P_ij = min(1/deg(i), w_j / (w_i · deg(j))) for j ~ i, the self-loop
    the rest. Detailed balance makes w/Σw stationary on a connected
    graph; with w ≡ 1 it equals :func:`metropolis_transition_matrix`."""
    adj = graph.adjacency.astype(np.float64)
    deg = adj.sum(axis=1)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    w = np.asarray(weights, np.float64)
    p = adj * np.minimum(inv[:, None], (w[None, :] * inv[None, :])
                         / w[:, None])
    np.fill_diagonal(p, np.maximum(1.0 - p.sum(axis=1), 0.0))
    return p


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


# Walk-policy axis: which stationary distribution the walk targets.
# "degree"/"metropolis" are the unbiased chains the paper uses;
# "staleness"/"label_skew" are importance-biased MH chains (π ∝ w) whose
# sampling bias the per-visit importance weights undo (docs/walks.md).
WALK_POLICIES = ("degree", "metropolis", "staleness", "label_skew")
BIASED_POLICIES = frozenset({"staleness", "label_skew"})


@dataclasses.dataclass
class RandomWalkServer:
    """The mobile server walking the client graph (Eq. 2). Host-side
    control plane: the visited sequence (i_k) decides which zone each
    round updates.

    ``policy`` picks the chain (defaults to ``transition``):

    * ``"degree"`` / ``"metropolis"``: the unbiased chains (π ∝ deg, π
      uniform); every importance weight is 1.0.
    * ``"staleness"``: the MH chain targeting π ∝ (1 + steps since the
      last visit)^γ (γ = ``bias_gamma``).
    * ``"label_skew"``: the MH chain targeting the fixed per-client
      utilities of :meth:`set_label_weights`
      (``data.partition.label_skew_weights``).

    Every visit records its importance weight ``(Σw)/(n·w_i)`` in
    ``weight_history``, aligned with ``history``: the Walk-for-Learning
    correction the trainers fold into the Eq. 31 y update.
    """

    transition: str = "degree"  # "degree" (paper) | "metropolis"
    seed: int = 0
    policy: str | None = None   # defaults to ``transition``
    bias_gamma: float = 1.0     # staleness exponent γ

    def __post_init__(self):
        if self.policy is None:
            self.policy = self.transition
        elif self.policy in ("degree", "metropolis"):
            # A uniform policy is a transition kind: keep them in step.
            self.transition = self.policy
        if self.policy not in WALK_POLICIES:
            raise ValueError(f"unknown walk policy {self.policy!r}; "
                             f"pick one of {WALK_POLICIES}")
        self._rng = np.random.default_rng(self.seed)
        self.position: int | None = None
        self.visit_counts: np.ndarray | None = None
        self.history: list[int] = []
        self.weight_history: list[float] = []
        self.label_weights: np.ndarray | None = None
        self._last_visit: np.ndarray | None = None
        self._n_seen = 0
        self._cover_step: int | None = None
        self._matrix_cache: tuple[Any, np.ndarray] | None = None

    # -- policy weights ---------------------------------------------------
    @property
    def is_biased(self) -> bool:
        return self.policy in BIASED_POLICIES

    def set_label_weights(self, weights: np.ndarray | None) -> None:
        """Install the ``label_skew`` policy's per-client utilities,
        normalized to mean 1."""
        if weights is None:
            self.label_weights = None
            return
        w = np.asarray(weights, np.float64)
        if (w <= 0).any():
            raise ValueError("label weights must be strictly positive")
        self.label_weights = w / w.mean()

    def policy_weights(self, n: int) -> np.ndarray:
        """(n,) target weights w (π ∝ w) at the current walker state;
        ones for the uniform policies."""
        if self.policy == "staleness":
            assert self._last_visit is not None, "call reset() first"
            k = len(self.history) - 1
            s = (k - self._last_visit).astype(np.float64)  # never seen → k+1
            return (1.0 + s) ** self.bias_gamma
        if self.policy == "label_skew" and self.label_weights is not None:
            if len(self.label_weights) != n:
                raise ValueError(
                    f"label weights have length {len(self.label_weights)}, "
                    f"graph has {n} clients")
            return self.label_weights
        return np.ones(n)

    def stationary_target(self, n: int) -> np.ndarray:
        """The designed stationary distribution π = w/Σw (uniform
        policies: 1/n; the degree chain's own π comes from
        ``stationary_distribution`` of its matrix)."""
        w = self.policy_weights(n)
        return w / w.sum()

    def matrix(self, graph: ClientGraph | NeighborGraph) -> np.ndarray:
        """P(k) on ``graph``, densified for a neighbor-list graph. The
        unbiased chains cache it per graph object (a weak reference, so
        a recycled id never aliases a dead graph); a biased chain's
        weights move with the walker state, so it is built afresh."""
        if self._matrix_cache is not None and not self.is_biased \
                and self._matrix_cache[0]() is graph:
            return self._matrix_cache[1]
        g = graph.to_dense() if isinstance(graph, NeighborGraph) else graph
        if self.is_biased:
            return biased_transition_matrix(g, self.policy_weights(graph.n))
        if self.transition == "degree":
            p = degree_transition_matrix(g)
        elif self.transition == "metropolis":
            p = metropolis_transition_matrix(g)
        else:
            raise ValueError(f"unknown transition kind {self.transition!r}")
        self._matrix_cache = (weakref.ref(graph), p)
        return p

    def reset(self, graph: ClientGraph | NeighborGraph,
              start: int | None = None) -> int:
        self.visit_counts = np.zeros(graph.n, dtype=np.int64)
        self.history = []
        self.weight_history = []
        self._last_visit = np.full(graph.n, -1, dtype=np.int64)
        self._n_seen = 0
        self._cover_step = None
        self.position = (int(self._rng.integers(graph.n))
                         if start is None else int(start))
        self._record_visit(self.position, graph.n, initial=True)
        return self.position

    def _record_visit(self, i: int, n: int, *, initial: bool = False) -> None:
        """Counts, history, this visit's importance weight (from the
        weights the step was drawn under, before the visit moves them),
        the staleness clock and the first-full-coverage step."""
        if initial or not self.is_biased:
            iw = 1.0
        else:
            w = self.policy_weights(n)
            iw = float(w.sum() / (n * w[i]))
        if self.visit_counts[i] == 0:
            self._n_seen += 1
            if self._n_seen == n and self._cover_step is None:
                self._cover_step = len(self.history)
        self.visit_counts[i] += 1
        self.history.append(i)
        self.weight_history.append(iw)
        self._last_visit[i] = len(self.history) - 1

    def transition_row(self, graph: ClientGraph | NeighborGraph,
                       i: int) -> np.ndarray:
        """Row i of P(k), bit-identical to the matrix's row. A cached
        matrix row is reused; otherwise the degree chain builds only the
        O(n) row (0/1 sums are exact, one division either way), the
        Metropolis chain goes through the cached matrix on a dense graph
        and the scattered sparse row on a neighbor-list one, and a biased
        chain always builds its row afresh (:meth:`_biased_row`)."""
        if self.is_biased:
            _, row = self._biased_row(graph, i)
            return row
        if self._matrix_cache is not None \
                and self._matrix_cache[0]() is graph:
            return self._matrix_cache[1][i]
        if isinstance(graph, NeighborGraph):
            cands, probs = self._sparse_row(graph, i)
            row = np.zeros(graph.n)
            row[cands] = probs
            return row
        if self.transition == "degree":
            row = graph.adjacency[i].astype(np.float64)
            return row / max(row.sum(), 1.0)
        return self.matrix(graph)[i]

    def _biased_row(self, graph: ClientGraph | NeighborGraph, i: int
                    ) -> tuple[np.ndarray, np.ndarray]:
        """(candidates, full row) of the biased MH chain at node i, one
        construction for both backends: only the neighbor and degree
        gather differs (the same integers either way), every float
        operation after it is shared and follows
        :func:`biased_transition_matrix`'s expression (multiply, divide,
        the length-n sum for the self-loop)."""
        w = self.policy_weights(graph.n)
        if isinstance(graph, NeighborGraph):
            nbrs = graph.neighbors(i)
            deg_nb = graph.nbr_mask[nbrs].sum(axis=1).astype(np.float64)
        else:
            nbrs = np.flatnonzero(graph.adjacency[i])
            nbrs = nbrs[nbrs != i]
            deg_nb = graph.adjacency[nbrs].astype(np.float64).sum(axis=1)
        deg_i = np.float64(len(nbrs))
        inv_i = np.where(deg_i > 0, 1.0 / np.maximum(deg_i, 1.0), 0.0)
        inv_nb = np.where(deg_nb > 0, 1.0 / np.maximum(deg_nb, 1.0), 0.0)
        row = np.zeros(graph.n)
        row[nbrs] = np.minimum(inv_i, (w[nbrs] * inv_nb) / w[i])
        # The matrix's clamp: rounded terms can sum a hair above 1.
        row[i] = max(1.0 - row.sum(), 0.0)
        cands = np.insert(nbrs, np.searchsorted(nbrs, i), i)
        return cands, row

    def _sparse_row(self, graph: NeighborGraph, i: int
                    ) -> tuple[np.ndarray, np.ndarray]:
        """(candidates, probs): the support of row i of P(k) in ascending
        client order on a neighbor-list graph, O(deg) for the degree
        chain. The floats equal the dense row's: the Metropolis
        self-loop scatters the neighbor masses into a length-n row first,
        so ``1 − row.sum()`` reduces as the dense matrix row does."""
        if self.is_biased:
            cands, row = self._biased_row(graph, i)
            return cands, row[cands]
        if self.transition == "degree":
            nbrs = graph.neighbors(i)
            return nbrs, np.full(len(nbrs), 1.0) / max(float(len(nbrs)),
                                                       1.0)
        if self.transition != "metropolis":
            raise ValueError(f"unknown transition kind {self.transition!r}")
        nbrs = graph.neighbors(i)
        deg_i = np.float64(len(nbrs))
        deg_nb = graph.nbr_mask[nbrs].sum(axis=1).astype(np.float64)
        inv_i = np.where(deg_i > 0, 1.0 / np.maximum(deg_i, 1.0), 0.0)
        inv_nb = np.where(deg_nb > 0, 1.0 / np.maximum(deg_nb, 1.0), 0.0)
        row = np.zeros(graph.n)
        row[nbrs] = np.minimum(inv_i, inv_nb)
        row[i] = max(1.0 - row.sum(), 0.0)
        cands = np.insert(nbrs, np.searchsorted(nbrs, i), i)
        return cands, row[cands]

    def _sample_sparse(self, graph: NeighborGraph, u: float) -> int:
        """Map one uniform through row ``position``'s CDF as
        ``Generator.choice(n, p=row)`` does on the dense row (cumsum,
        normalize, searchsorted-right) over the row's support only."""
        cands, probs = self._sparse_row(graph, self.position)
        cdf = probs.cumsum()
        cdf /= cdf[-1]
        j = int(np.searchsorted(cdf, u, side="right"))
        return int(cands[min(j, len(cands) - 1)])

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

    def walk_schedule_batched(self, graphs: Sequence[ClientGraph],
                              *, advance_first: bool = True) -> np.ndarray:
        """Inverse-CDF variant of :meth:`walk_schedule`: the window's
        step uniforms come from one ``rng.random`` call and each step
        maps its uniform through its row's CDF. It consumes the walker's
        stream differently from ``choice``, so it breaks from the eager
        walk and is opt-in (the trainers' ``batched_walk``); chunks
        compose, as ``random(a)`` then ``random(b)`` equals
        ``random(a + b)``."""
        rounds = len(graphs)
        positions = np.empty(rounds, dtype=np.int64)
        start = 0
        if rounds and not advance_first:
            assert self.position is not None, "call reset() first"
            positions[0] = self.position
            start = 1
        u = self._rng.random(rounds - start)
        for k in range(start, rounds):
            assert self.position is not None, "call reset() first"
            if isinstance(graphs[k], NeighborGraph):
                cands, row = self._sparse_row(graphs[k], self.position)
            else:
                cands = None
                row = self.transition_row(graphs[k], self.position)
            cdf = np.cumsum(row)
            # Scaled by the realized total so undershoot in the cumsum
            # never pushes the draw past the last bin.
            j = int(np.searchsorted(cdf, u[k - start] * cdf[-1],
                                    side="right"))
            # Clamp to the first bin reaching the total: the last state
            # the row supports (trailing zero-mass states share cdf[-1]).
            j = min(j, int(np.searchsorted(cdf, cdf[-1], side="left")))
            self.position = int(cands[j]) if cands is not None else j
            self._record_visit(self.position, graphs[k].n)
            positions[k] = self.position
        return positions

    def walk_weights(self, rounds: int) -> np.ndarray | None:
        """(R,) importance weights of the last ``rounds`` visits (the
        schedules' ``iw`` column), or None for an unbiased policy, whose
        rounds then run no correction at all."""
        if not self.is_biased:
            return None
        if rounds == 0:
            return np.zeros(0, np.float64)
        assert rounds <= len(self.weight_history)
        return np.asarray(self.weight_history[-rounds:], np.float64)


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

    Under a biased walk policy one more column reaches the device's y
    update (the Walk-for-Learning correction):

    iw: (R,) float64 — importance weight 1/(n·π_{i_k}) of the visited
        client, or None for an unbiased policy (no correction runs).
    """

    idx: np.ndarray
    mask: np.ndarray
    n_i: np.ndarray
    keys: np.ndarray
    clients: np.ndarray
    active: np.ndarray
    latency_s: np.ndarray | None = None
    energy_j: np.ndarray | None = None
    iw: np.ndarray | None = None

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
                  *, start_round: int = 0, price=None,
                  batched_walk: bool = False) -> ZoneSchedule:
    """Precompute ``rounds`` zone rounds: graphs (regeneration epochs
    included), walk positions, padded zones and seeds. Advances
    ``dyn_graph``, ``walker`` and ``rng`` exactly as the same number of
    eager rounds would, so consecutive chunks compose into one run.

    ``dyn_graph`` is a ``DynamicGraph`` or a ``scenarios.Scenario``,
    whose churn masks feed zone planning. ``price(graphs, clients, idx,
    mask) -> ((R,), (R,))`` prices the window (no RNG) into the
    ``latency_s`` and ``energy_j`` columns. ``batched_walk`` walks with
    :meth:`RandomWalkServer.walk_schedule_batched` (another stream than
    the eager walk's, so opt-in)."""
    first = start_round == 0
    graphs = dyn_graph.schedule(rounds, include_current=first)
    avails = _pop_avails(dyn_graph)
    step = (walker.walk_schedule_batched if batched_walk
            else walker.walk_schedule)
    positions = step(graphs, advance_first=not first)
    # The last `rounds` weights align with `positions` either way: the
    # round-0 entry is the current position, weighted when visited.
    iw = walker.walk_weights(rounds)
    idx, mask, n_i, seeds, active = _plan_rounds(
        graphs, positions, zone_size, rng, avails)
    latency = energy = None
    if price is not None:
        latency, energy = price(graphs, positions, idx, mask)
    return ZoneSchedule(idx=idx, mask=mask, n_i=n_i, keys=round_keys(seeds),
                        clients=positions.astype(np.int32), active=active,
                        latency_s=latency, energy_j=energy, iw=iw)


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

    Under a biased walk policy the ``iw`` column is (R,) in round-robin
    mode (the active walker's weight) and (R, K) in simultaneous mode.
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
                        price=None, price_fleet=None,
                        batched_walk: bool = False) -> FleetZoneSchedule:
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
    availability mask, stepped ones against the window's.

    Under a biased policy a parked round carries its walker's last
    recorded weight (1.0 for the reset visit), a stepped one the weight
    of the visit it made. ``batched_walk`` as in :func:`zone_schedule`."""
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
    step_name = "walk_schedule_batched" if batched_walk else "walk_schedule"
    biased = any(w.is_biased for w in walkers)

    if mode == "roundrobin":
        active_walker = ((start_round + np.arange(rounds))
                         % k_walkers).astype(np.int32)
        positions = np.empty((rounds,), np.int64)
        iw = np.ones((rounds,), np.float64) if biased else None
        for k, w in enumerate(walkers):
            # Each walker's RNG is its own, so grouping the rounds by
            # walker replays the per-round order exactly.
            mine = np.flatnonzero(active_walker == k)
            parked = mine[mine < lead]
            if len(parked):
                assert w.position is not None, "call reset() first"
                positions[parked] = w.position
                if iw is not None:
                    iw[parked] = w.weight_history[-1]
            moving = mine[mine >= lead]
            if len(moving):
                positions[moving] = getattr(w, step_name)(
                    [graphs[r] for r in moving], advance_first=True)
                if iw is not None and w.is_biased:
                    iw[moving] = w.walk_weights(len(moving))
        idx, mask, n_i, seeds, active = _plan_rounds(
            graphs, positions, zone_size, rng, avails)
        latency = energy = None
        if price is not None:
            latency, energy = price(graphs, positions, idx, mask)
        return FleetZoneSchedule(
            idx=idx, mask=mask, n_i=n_i, keys=round_keys(seeds),
            clients=positions.astype(np.int32), active=active,
            latency_s=latency, energy_j=energy, iw=iw,
            walker=active_walker, sync=sync, mode=mode)

    positions = np.empty((rounds, k_walkers), np.int64)
    iw = np.ones((rounds, k_walkers), np.float64) if biased else None
    for k, w in enumerate(walkers):
        if lead:
            assert w.position is not None, "call reset() first"
            positions[0, k] = w.position
            if iw is not None:
                iw[0, k] = w.weight_history[-1]
        if rounds > lead:
            positions[lead:, k] = getattr(w, step_name)(stepped,
                                                        advance_first=True)
            if iw is not None and w.is_biased:
                iw[lead:, k] = w.walk_weights(rounds - lead)
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
        latency_s=latency, energy_j=energy, iw=iw, sync=sync,
        latency_s_walkers=lat_kw, energy_j_walkers=en_kw, mode=mode)


def _sync_mask(start_round: int, rounds: int, sync_every: int) -> np.ndarray:
    """(R,) float32 rendezvous mask: 1.0 after rounds where
    ``(rnd + 1) % sync_every == 0``, the eager fleet's trigger."""
    rs = start_round + np.arange(rounds)
    return ((rs + 1) % max(int(sync_every), 1) == 0).astype(np.float32)
