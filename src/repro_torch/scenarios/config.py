"""Scenario configuration dataclasses + named-scenario registry.

A scenario is the full environment the mobile server operates in
(paper §5's "infrastructure-less wireless environment"), split into
three orthogonal, individually-toggleable layers:

  * **mobility** — how client positions evolve and how connectivity is
    derived from them (``mobility.py``),
  * **links** — per-link wireless quality: log-distance path loss +
    shadowing → success probability, stochastic link dropouts, and the
    comm-cost model pricing each round in bytes/latency/energy
    (``links.py``),
  * **churn** — client availability: duty-cycled radios and stragglers
    masked out of zones (``churn.py``).

Everything here is host-side control plane: scenarios decide *which*
clients form each round's zone and what the round costs, then compile
into the fixed-shape ``ZoneSchedule`` arrays, so the captured
``engine="scan"``/``"scan_fused"`` windows are scenario-agnostic. Port
of ``repro/scenarios/config.py``: the same presets, field for field.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MobilityConfig:
    """How client positions (unit square) evolve per round.

    model:
      * ``static_regen`` — i.i.d. position redraw every ``regen_every``
        rounds (``core.graph.DynamicGraph``, bit-for-bit).
      * ``random_waypoint`` — each client moves toward a uniformly drawn
        waypoint at a per-leg speed in [speed_min, speed_max], pausing
        ``pause_rounds`` on arrival.
      * ``gauss_markov`` — temporally correlated velocities,
        v' = α v + (1−α) v̄ + σ√(1−α²) w, reflected at the boundary.
      * ``trace`` — replay a recorded (R, n, 2) position trace named by
        ``trace_path`` (a ``register_trace`` name or an ``.npz``/``.npy``
        file), looping past the end; consumes no RNG.
    """

    model: str = "static_regen"
    min_degree: int = 5          # degree floor patched into connectivity
    regen_every: int = 10        # static_regen redraw period (rounds)
    radio_range: float = 0.35    # connectivity radius (unit square)
    speed_min: float = 0.01      # random_waypoint leg speed (units/round)
    speed_max: float = 0.05
    pause_rounds: int = 0        # random_waypoint dwell time at waypoints
    alpha: float = 0.85          # gauss_markov velocity memory
    mean_speed: float = 0.02     # gauss_markov long-run speed v̄ magnitude
    sigma_speed: float = 0.01    # gauss_markov velocity noise σ
    # trace replay source: a name registered via
    # scenarios.register_trace(name, positions) or a path to an .npz
    # (key "positions") / .npy file holding an (R, n, 2) unit-square
    # array. A plain string keeps this dataclass hashable/frozen.
    trace_path: str = ""


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    """Wireless link quality: log-distance path loss + shadowing.

    PL(d) = ref_loss_db + 10·η·log10(max(d, d0)/d0), and the fade margin
    M(d) = tx_power_dbm − sensitivity_dbm − PL(d). Shadowing is folded
    into a logistic success curve  p(d) = σ(M(d)/shadowing_db), clipped
    to [min_success, 1]. When ``dropout`` is set, each edge survives a
    round with probability p(d) (then connectivity is re-patched so the
    walk chain stays irreducible).
    """

    enabled: bool = False
    path_loss_exp: float = 3.0       # η
    ref_loss_db: float = 40.0        # PL at the reference distance d0
    ref_distance: float = 0.05       # d0 (unit-square units)
    tx_power_dbm: float = 10.0
    sensitivity_dbm: float = -68.0
    shadowing_db: float = 8.0        # logistic shadowing scale
    min_success: float = 0.05        # retransmission-count cap = 1/this
    dropout: bool = True             # Bernoulli(p) per-edge per-round


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Round pricing constants (first-order radio model, Heinzelman
    et al.): E_tx(b, d) = b·(e_elec + e_amp·d^η), E_rx(b) = b·e_elec,
    latency per transmission = base_latency_s + bytes/bandwidth, scaled
    by expected retransmissions 1/p(d) under the link model. Constants
    are illustrative but internally consistent (bytes, seconds, joules,
    unit-square distances)."""

    bandwidth_bytes_per_s: float = 1.5e6   # ~12 Mbit/s short-range radio
    base_latency_s: float = 0.002          # per-transmission overhead
    e_elec_j_per_byte: float = 4e-7        # electronics energy, tx & rx
    e_amp_j_per_byte: float = 8e-7         # amplifier energy at d = 1


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Client availability. Duty-cycling: client i is awake iff
    ((round + phase_i) mod period) < duty_cycle·period, with per-client
    phases drawn once. Stragglers: a fixed ``straggler_frac`` subset
    additionally misses each round with probability ``straggler_p``
    (slow compute / drained battery). The visited client i_k always
    participates — the server is physically at its location."""

    enabled: bool = False
    duty_cycle: float = 0.75
    period: int = 20
    straggler_frac: float = 0.0
    straggler_p: float = 0.5


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    name: str = "custom"
    mobility: MobilityConfig = MobilityConfig()
    links: LinkConfig = LinkConfig()
    comm: CommConfig = CommConfig()
    churn: ChurnConfig = ChurnConfig()
    # Batched-rollout chunk: Scenario.schedule materializes at most this
    # many rounds of (R, n, n) link/geometry tensors at once — the
    # memory/speed trade-off knob for large windows.
    # RNG consumption is chunk-size-invariant, so changing it never
    # changes trajectories.
    rollout_chunk: int = 128
    # Graph backend: "dense" keeps O(n²) adjacency/distance matrices
    # (the small-n oracle); "sparse" stores capped-degree (n, k) neighbor
    # lists built by grid-bucket search — O(n·k) control plane, the
    # large-n lane. Everything
    # RNG-free (graphs, zones, pricing) is bit-identical across
    # backends; link *dropout sampling* draws per-edge instead of per-
    # matrix, a documented RNG-stream break between backends.
    graph_backend: str = "dense"
    # Sparse-backend degree cap: each node keeps at most this many
    # in-range neighbors (nearest first); min-degree/connectivity
    # patches may exceed it (lists grow). For dense-parity at small n,
    # set it at or above the realized max degree.
    neighbor_k_max: int = 64


# ---------------------------------------------------------------------------
# Registry: named presets + user registration.
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ScenarioConfig] = {}


def register_scenario(cfg: ScenarioConfig) -> ScenarioConfig:
    """Register (or overwrite) a named scenario preset."""
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_scenario_config(name: str) -> ScenarioConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def available_scenarios() -> list[str]:
    return sorted(_REGISTRY)


register_scenario(ScenarioConfig(name="static_regen"))
register_scenario(ScenarioConfig(
    name="random_waypoint",
    mobility=MobilityConfig(model="random_waypoint"),
))
register_scenario(ScenarioConfig(
    name="gauss_markov",
    mobility=MobilityConfig(model="gauss_markov"),
))
# Lossy urban canyon: waypoint mobility + shadowed links that drop.
register_scenario(ScenarioConfig(
    name="lossy_links",
    mobility=MobilityConfig(model="random_waypoint"),
    links=LinkConfig(enabled=True),
))
# Battery-constrained fleet: duty-cycled radios + stragglers.
register_scenario(ScenarioConfig(
    name="duty_cycle",
    mobility=MobilityConfig(model="random_waypoint"),
    churn=ChurnConfig(enabled=True, straggler_frac=0.2),
))
# Everything at once: the paper's tactical-field setting, worst case.
register_scenario(ScenarioConfig(
    name="field_trial",
    mobility=MobilityConfig(model="gauss_markov"),
    links=LinkConfig(enabled=True),
    churn=ChurnConfig(enabled=True, straggler_frac=0.2),
))
