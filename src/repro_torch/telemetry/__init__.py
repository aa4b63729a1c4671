"""Telemetry: structured run recording for the port (port of
``repro/telemetry``; the same event schema and ``SCHEMA_VERSION``).

One :class:`TelemetryRun` per recorded run captures a manifest (config,
seed, git SHA, torch/CUDA versions, the device's name and power limit,
package versions) and streams typed events — ``round`` / ``visit`` /
``snapshot`` / ``phase`` / ``counter`` — to ``runs/<id>/events.jsonl``.
Every layer emits into it through an optional ``telemetry=`` hook
(``run_simulation``, the RWSADMM single walker and fleet, the baselines,
``Scenario``, the client store); the default ``None`` keeps every run
bit for bit what it was, with no device sync added.

Render a recorded run with ``python -m repro_torch.telemetry.report
runs/<id>``.
"""
from .artifacts import (
    atomic_write_json,
    atomic_write_text,
    load_bench_rows,
    merge_bench_rows,
)
from .events import (
    EVENT_TYPES,
    SCHEMA_VERSION,
    TelemetryError,
    read_events,
    split_by_type,
    validate_event,
)
from .profiler import annotate, maybe_trace, profiling_enabled
from .recorder import (
    PhaseSpan,
    TelemetryRun,
    manifest_fingerprint,
    null_phase,
    telemetry_print,
)
from .trace import visit_events_from_round, visit_events_from_schedule

__all__ = [
    "EVENT_TYPES",
    "SCHEMA_VERSION",
    "PhaseSpan",
    "TelemetryError",
    "TelemetryRun",
    "annotate",
    "atomic_write_json",
    "atomic_write_text",
    "load_bench_rows",
    "manifest_fingerprint",
    "maybe_trace",
    "merge_bench_rows",
    "null_phase",
    "profiling_enabled",
    "read_events",
    "split_by_type",
    "telemetry_print",
    "validate_event",
    "visit_events_from_round",
    "visit_events_from_schedule",
]
