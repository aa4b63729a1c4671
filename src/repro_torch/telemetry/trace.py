"""Walk/zone trace stream: per-visit event records (port of
``repro/telemetry/trace.py``).

The scan drivers already materialize everything a walk trace needs as
fixed-shape host arrays (``core.markov.ZoneSchedule`` /
``FleetZoneSchedule``: visited clients, zone sizes, importance weights,
CommModel latency/energy columns), so tracing a whole chunk is one
vectorized column extraction + one serialization loop — never per-step
Python inside the hot path, and never a device sync (the columns are
host-side control plane by construction).

Eager rounds trace through :func:`visit_events_from_round`, which reads
the round's already-built ``round_metrics`` entry.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

#: per-round metric keys copied onto that round's visit events
_ROUND_CARRY = ("staleness_p50", "staleness_max")


def _opt(col, j):
    return None if col is None else float(np.asarray(col[j]))


def visit_events_from_schedule(sched, start_round: int,
                               round_entries: list[dict] | None = None,
                               ) -> Iterator[dict]:
    """Yield one ``visit`` event dict per walker visit in a finished
    schedule chunk (single-walker and round-robin fleet: one per round;
    simultaneous fleet: one per walker per wall step).

    ``round_entries`` (the chunk's ``chunk_round_metrics`` output,
    aligned by round) contributes the per-round staleness columns —
    those live on the trainer's service clock, not in the schedule.
    """
    clients = np.asarray(sched.clients)
    fleet_sim = clients.ndim == 2            # simultaneous: (R, K)
    active = np.asarray(sched.active)
    n_i = np.asarray(sched.n_i)
    walker = getattr(sched, "walker", None)  # round-robin fleet: (R,)
    iw = sched.iw
    lat = sched.latency_s
    en = sched.energy_j
    lat_w = getattr(sched, "latency_s_walkers", None)   # (R, K) or None
    en_w = getattr(sched, "energy_j_walkers", None)
    for j in range(sched.rounds):
        carry: dict = {}
        if round_entries is not None:
            entry = round_entries[j]
            carry = {k: entry[k] for k in _ROUND_CARRY if k in entry}
        if fleet_sim:
            for k in range(clients.shape[1]):
                e = {"round": start_round + j, "walker": k,
                     "client": int(clients[j, k]),
                     "zone": int(active[j, k]), "n_i": int(n_i[j, k]),
                     **carry}
                if iw is not None:
                    e["iw"] = float(np.asarray(iw[j, k]))
                if lat_w is not None:
                    e["latency_s"] = float(np.asarray(lat_w[j, k]))
                    e["energy_j"] = float(np.asarray(en_w[j, k]))
                yield e
        else:
            e = {"round": start_round + j, "client": int(clients[j]),
                 "zone": int(active[j]), "n_i": int(n_i[j]), **carry}
            if walker is not None:
                e["walker"] = int(walker[j])
            if iw is not None:
                e["iw"] = float(np.asarray(iw[j]))
            if lat is not None:
                e["latency_s"] = _opt(lat, j)
                e["energy_j"] = _opt(en, j)
            yield e


def visit_events_from_round(metrics: dict) -> Iterator[dict]:
    """Visit event(s) for one eager round, from its ``round_metrics``
    entry. Single-walker / round-robin entries carry ``client`` (and
    maybe ``walker``); simultaneous-fleet entries carry a ``clients``
    tuple and only wall-step aggregates, so their per-visit events hold
    the shared round columns."""
    carry = {k: metrics[k] for k in _ROUND_CARRY if k in metrics}
    base = {"round": metrics["round"], **carry}
    for k in ("iw", "latency_s", "energy_j"):
        if k in metrics and not isinstance(metrics.get("clients"), tuple):
            base[k] = metrics[k]
    if isinstance(metrics.get("clients"), tuple):
        for w, c in enumerate(metrics["clients"]):
            yield {**base, "walker": w, "client": int(c)}
    elif "client" in metrics:
        e = {**base, "client": int(metrics["client"]),
             "zone": metrics.get("zone"), "n_i": metrics.get("n_i")}
        if "walker" in metrics:
            e["walker"] = int(metrics["walker"])
        yield {k: v for k, v in e.items() if v is not None}
