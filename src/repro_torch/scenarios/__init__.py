"""Scenario subsystem: mobility models, wireless links, client churn.

Composable, config-driven environments for the mobile-server random
walk — all host-side control plane that compiles into the fixed-shape
``ZoneSchedule`` arrays, keeping the ``engine="scan"``/``"scan_fused"``
windows scenario-agnostic. Port of ``repro/scenarios`` (numpy only): the
same presets, streams and prices, held to the reference by ``==``.
"""
from .churn import ChurnModel
from .config import (
    ChurnConfig,
    CommConfig,
    LinkConfig,
    MobilityConfig,
    ScenarioConfig,
    available_scenarios,
    get_scenario_config,
    register_scenario,
)
from .links import CommModel, LinkModel
from .mobility import (
    GRAPH_BACKENDS,
    GaussMarkovMobility,
    MobilityModel,
    RandomWaypointMobility,
    StaticRegenMobility,
    TraceMobility,
    build_mobility,
    load_trace,
    range_graph,
    range_graphs_batch,
    register_trace,
    sparse_knn_graph,
    sparse_range_graph,
)
from .scenario import Scenario, build_scenario

__all__ = [
    "ChurnConfig",
    "ChurnModel",
    "CommConfig",
    "CommModel",
    "GRAPH_BACKENDS",
    "GaussMarkovMobility",
    "LinkConfig",
    "LinkModel",
    "MobilityConfig",
    "MobilityModel",
    "RandomWaypointMobility",
    "Scenario",
    "ScenarioConfig",
    "StaticRegenMobility",
    "TraceMobility",
    "available_scenarios",
    "build_mobility",
    "build_scenario",
    "get_scenario_config",
    "load_trace",
    "range_graph",
    "range_graphs_batch",
    "register_scenario",
    "register_trace",
    "sparse_knn_graph",
    "sparse_range_graph",
]
