"""Scenario: mobility + links + churn behind the DynamicGraph contract.

A ``Scenario`` is a drop-in replacement for ``core.graph.DynamicGraph``
(``current()`` / ``step()`` / ``schedule()``), so the random walker, the
eager engine, and the precomputed-schedule engines all work unchanged. Per
round it:

  1. advances the mobility model (positions → base connectivity),
  2. applies stochastic link dropouts (link layer) to the adjacency,
  3. advances the churn model (availability mask for zone planning),

and offers deterministic comm pricing (latency/energy) for whatever
zone the planner forms. Everything is host-side control plane; the
fixed-shape ``ZoneSchedule`` arrays it compiles into are all the device
ever sees, so ``engine="scan"``/``"scan_fused"`` keep the fused hot
path under every scenario.

``schedule()`` is a **batched rollout**, not R ``step()`` iterations:
each layer generates its whole window in a few vectorized passes
(mobility positions + graphs, the (R, n, n) link-dropout tensor, the
(R, n) churn masks), chunked to ``cfg.rollout_chunk`` rounds so the
O(R·n²) intermediates stay bounded for large windows. Every lane —
``step()``, batched ``schedule()``, and stepped ``schedule(batched=
False)`` — consumes the RNG streams identically, so they replay each
other draw-for-draw.

Three independent RNG streams (mobility / links / churn) are derived
from the seed, so toggling one layer never perturbs another layer's
draw sequence. With the default ``static_regen`` config (links and
churn off) the mobility stream consumes exactly like ``DynamicGraph``'s
single RNG — bit-for-bit identical trajectories.

Port of ``repro/scenarios/scenario.py`` (without the telemetry spans:
the port has no telemetry yet).

``positions_only=True`` drops the connectivity stack entirely: the
mobility model advances positions (identical RNG consumption — the
graph construction is RNG-free) but never builds adjacency, never
patches degrees or components, and the link layer never samples
dropouts. The FedAvg-family base-station baselines run in this mode:
they only consume positions (pricing against the base station) and
churn masks (selection), so the O(n²)-per-round graph work is pure
waste for them.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import ClientGraph, detach_rollout_views
from .churn import ChurnModel
from .config import ScenarioConfig, get_scenario_config
from .links import CommModel, LinkModel
from .mobility import build_mobility


class Scenario:
    def __init__(self, n: int, cfg: ScenarioConfig | str, seed: int = 0,
                 *, positions_only: bool = False):
        if isinstance(cfg, str):
            cfg = get_scenario_config(cfg)
        self.n = n
        self.cfg = cfg
        self.positions_only = bool(positions_only)
        self.mobility = build_mobility(n, cfg.mobility,
                                       backend=cfg.graph_backend,
                                       k_max=cfg.neighbor_k_max)
        # Stream 0 mirrors DynamicGraph(seed) exactly (static_regen
        # bit-compat); links/churn get independent streams. A negative
        # seed never reaches the SeedSequence: default_rng(seed) above
        # it already rejects one.
        self._rng_mob = np.random.default_rng(seed)
        self._rng_link = np.random.default_rng(
            np.random.SeedSequence([seed, 1]))
        self._rng_churn = np.random.default_rng(
            np.random.SeedSequence([seed, 2]))
        self.link = LinkModel(cfg.links) if cfg.links.enabled else None
        self.churn = ChurnModel(n, cfg.churn) if cfg.churn.enabled else None
        self.comm = CommModel(cfg.comm, self.link)
        self._round = 0
        if self.positions_only:
            self._base = self.graph = None
            self._pos = self.mobility.reset_positions(self._rng_mob)
        else:
            self._base = self.mobility.reset(self._rng_mob)
            self.graph = self._effective(self._base)
            self._pos = self._base.positions
        self.avail = (self.churn.reset(self._rng_churn)
                      if self.churn is not None else None)
        self._avail_trace: np.ndarray | None = None

    # -- DynamicGraph contract -------------------------------------------
    @property
    def n_regens(self) -> int:
        return getattr(self.mobility, "n_regens", 0)

    @property
    def positions(self) -> np.ndarray:
        """(n, 2) current client positions (works in every mode)."""
        return self._pos

    def current(self) -> ClientGraph:
        if self.graph is None:
            raise RuntimeError(
                "positions-only scenario has no connectivity graph; "
                "rebuild with positions_only=False for graph walking")
        return self.graph

    def step(self) -> ClientGraph | None:
        """Advance one round: mobility, link dropouts, churn. In
        positions-only mode just positions and churn — the whole
        connectivity stack (adjacency, degree floor, component patch,
        dropout sampling) is skipped."""
        self._round += 1
        if self.positions_only:
            self._pos = self.mobility.step_positions(self._rng_mob)
        else:
            self._base = self.mobility.step(self._rng_mob)
            self.graph = self._effective(self._base)
            self._pos = self._base.positions
        if self.churn is not None:
            self.avail = self.churn.step(self._round, self._rng_churn)
        return self.graph

    def schedule(self, rounds: int, *, include_current: bool = False,
                 batched: bool = True) -> list[ClientGraph]:
        """Batch variant of :meth:`step` (same contract as
        ``DynamicGraph.schedule``). Also records the per-round
        availability masks for the same window; ``pop_avail_trace()``
        hands them to ``markov.zone_schedule`` aligned with the graphs.

        ``batched=True`` (default) runs the vectorized rollout engine:
        one array program per layer per ≤``cfg.rollout_chunk``-round
        chunk. ``batched=False`` keeps the legacy per-round stepping —
        same RNG consumption, bit-identical output (the equivalence is
        pinned in tests); it exists as the oracle for that pin.
        """
        if self.positions_only:
            raise RuntimeError(
                "positions-only scenario cannot compile graph schedules; "
                "rebuild with positions_only=False for graph walking")
        graphs: list[ClientGraph] = []
        avails: list[np.ndarray] = []
        if include_current:
            graphs.append(self.current())
            avails.append(self.avail)
        if batched:
            chunk = max(1, int(self.cfg.rollout_chunk))
            while len(graphs) < rounds:
                m = min(rounds - len(graphs), chunk)
                base = self.mobility.rollout(m, self._rng_mob)
                if self.link is not None:
                    eff = self.link.apply_dropouts_batch(
                        base, self._rng_link)
                else:
                    eff = base
                if self.churn is not None:
                    block = self.churn.rollout(
                        self._round + 1, m, self._rng_churn)
                    avails.extend(block)
                    self.avail = block[-1]
                self._round += m
                graphs.extend(eff)
                self._base = base[-1]
                self.graph = eff[-1]
        else:
            while len(graphs) < rounds:
                graphs.append(self.step())
                avails.append(self.avail)
        # Copy-on-seed: the scenario retains the window's last graphs as
        # its current state; their arrays/caches are views into the
        # rollout's (R, n, n)/(R, n, 2) stacks and would pin the whole
        # window in memory. Detach BEFORE mirroring positions so _pos
        # references the copy, not the stack.
        for g in (self._base, self.graph):
            if g is not None:
                detach_rollout_views(g)
        self._pos = self._base.positions
        self._avail_trace = (np.stack(avails)
                             if self.churn is not None else None)
        return graphs

    def pop_avail_trace(self) -> np.ndarray | None:
        """(R, n) availability masks aligned with the last
        :meth:`schedule` call (None when churn is disabled — the
        planner then consumes RNG exactly like the pre-scenario path)."""
        trace, self._avail_trace = self._avail_trace, None
        return trace

    # -- layers -----------------------------------------------------------
    def _effective(self, base: ClientGraph) -> ClientGraph:
        """Link-layer view of the mobility graph. Without a link model
        this is ``base`` itself (same object — the walker's per-graph
        transition-matrix cache keeps hitting between regens)."""
        if self.link is None:
            return base
        return self.link.apply_dropouts(base, self._rng_link)

    def availability(self) -> np.ndarray | None:
        """(n,) bool mask for the current round, or None (all on)."""
        return self.avail

    def price_round(self, graph: ClientGraph, i_k: int, idx: np.ndarray,
                    mask: np.ndarray, payload_bytes: int
                    ) -> tuple[float, float]:
        """(latency_s, energy_j) for one zone round — deterministic, so
        eager rounds and precomputed schedules price identically."""
        return self.comm.price_round(graph, i_k, idx, mask, payload_bytes)

    def price_schedule(self, graphs, clients, idx, mask,
                       payload_bytes: int):
        """Vectorized pricing of a whole precomputed schedule window
        (one pass — same math as R ``price_round`` calls)."""
        return self.comm.price_schedule(graphs, clients, idx, mask,
                                        payload_bytes)

    def price_fleet_schedule(self, graphs, clients, idx, mask,
                             payload_bytes: int):
        """Per-walker pricing of a simultaneous-fleet window: clients
        (R, K), idx/mask (R, K, Z) → ((R, K), (R, K)) latency/energy."""
        return self.comm.price_fleet_schedule(graphs, clients, idx, mask,
                                              payload_bytes)

    def price_star_round(self, members: np.ndarray, payload_bytes: int
                         ) -> tuple[float, float]:
        """Baseline (base-station) pricing against current positions
        (graph-free: works in positions-only mode)."""
        return self.comm.price_star_round(
            self._pos, members, payload_bytes)


def build_scenario(spec: ScenarioConfig | str | None, n: int,
                   seed: int = 0, *, min_degree: int = 5,
                   regen_every: int = 10,
                   positions_only: bool = False) -> Scenario:
    """Resolve a scenario spec (name, config, or None) into a Scenario.

    ``None`` builds the default ``static_regen`` from the caller's
    legacy graph knobs (min_degree/regen_every) — the exact
    ``core.graph.DynamicGraph`` behavior. A named or explicit config is
    authoritative: its own mobility knobs win over the legacy kwargs.

    ``positions_only=True`` skips the whole connectivity stack — for
    base-station consumers (the FedAvg-family baselines) that only read
    positions and churn masks.
    """
    if spec is None:
        import dataclasses

        base = get_scenario_config("static_regen")
        spec = dataclasses.replace(
            base, mobility=dataclasses.replace(
                base.mobility, min_degree=min_degree,
                regen_every=regen_every),
        )
    return Scenario(n, spec, seed=seed, positions_only=positions_only)
