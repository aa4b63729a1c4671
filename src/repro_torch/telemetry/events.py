"""Typed telemetry event schema: one JSONL line per event (port of
``repro/telemetry/events.py``; the same schema and version).

Every event is a flat JSON object with a ``t`` discriminator naming its
type plus that type's required fields (free-form extras ride along).
The same schema serves training runs (``run_simulation``), the fleet
driver, the FedAvg-family baselines, and the benchmark harness, so one
report CLI can read any artifact under ``runs/``.

Event types
-----------
``round``    — one training/communication round: ``round`` plus whatever
               the trainer's ``round_metrics`` entry carries
               (``train_loss``, ``comm_bytes``, ``latency_s``, …).
``visit``    — one walker visit in the walk/zone trace stream:
               ``round``, ``client``; optionally ``walker``, ``zone``,
               ``n_i``, ``iw``, ``staleness_p50``/``staleness_max``,
               ``latency_s``/``energy_j`` (CommModel columns).
``snapshot`` — one evaluation snapshot: ``round`` plus the eval dict
               (``acc``, ``acc_personalized``, ``comm_bytes_total``, …).
``phase``    — one fenced phase-timer span: ``name``, ``seconds``;
               optionally ``round``, ``engine``, ``includes_compile``.
``counter``  — one named scalar: ``name``, ``value`` (totals, config
               echoes, benchmark readings).
"""
from __future__ import annotations

import json
from typing import Any, Iterable, Iterator

SCHEMA_VERSION = 1

#: required keys per event type (beyond the ``t`` discriminator)
EVENT_TYPES: dict[str, tuple[str, ...]] = {
    "round": ("round",),
    "visit": ("round", "client"),
    "snapshot": ("round",),
    "phase": ("name", "seconds"),
    "counter": ("name", "value"),
}


class TelemetryError(ValueError):
    """Malformed event or artifact."""


def _json_default(o: Any):
    """Serialize numpy scalars/arrays (and 0-d tensors) without importing
    numpy eagerly."""
    if hasattr(o, "item") and callable(o.item) and getattr(
            o, "ndim", None) == 0:
        return o.item()
    if hasattr(o, "tolist") and callable(o.tolist):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


def validate_event(event: dict) -> dict:
    """Check the discriminator and required fields; return the event."""
    etype = event.get("t")
    if etype not in EVENT_TYPES:
        raise TelemetryError(
            f"unknown event type {etype!r}; expected one of "
            f"{sorted(EVENT_TYPES)}")
    missing = [k for k in EVENT_TYPES[etype] if k not in event]
    if missing:
        raise TelemetryError(
            f"{etype!r} event missing required field(s) {missing}: "
            f"{sorted(event)}")
    return event


def encode_event(event: dict) -> str:
    """One JSONL line (validated, compact separators, sorted keys so a
    fixed-seed run writes byte-identical event streams)."""
    validate_event(event)
    return json.dumps(event, separators=(",", ":"), sort_keys=True,
                      default=_json_default)


def read_events(path: str) -> Iterator[dict]:
    """Stream events back from a JSONL file, re-validating each line."""
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError as e:
                raise TelemetryError(
                    f"{path}:{lineno}: bad JSON: {e}") from e
            yield validate_event(event)


def split_by_type(events: Iterable[dict]) -> dict[str, list[dict]]:
    """Bucket an event stream by type (missing types → empty lists)."""
    out: dict[str, list[dict]] = {t: [] for t in EVENT_TYPES}
    for e in events:
        out[e["t"]].append(e)
    return out
