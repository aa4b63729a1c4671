"""FL simulation runner (port of ``repro/fl/simulation.py``): drives a
trainer for R rounds and records eval history, per-round metrics,
communication totals and wall time.

* ``engine="eager"``: one ``trainer.round`` call (one host sync) per round.
* ``engine="scan" | "scan_fused"``: each eval window's walk/zone schedule
  is precomputed on the host, then the window runs with no host sync
  inside (``trainer.run_chunk``); metrics come back once per window.
  Same trajectories as eager: the schedule replays the eager draws.

Both engines emit ``round_metrics`` under one schema
(``fl.base.normalize_round_metrics`` / ``validate_round_metrics``).
The trainer fixes the device (cuda unless it was built for the CPU).
A ``FleetRWSADMMTrainer`` runs through the same calls: its own
``round``/``schedule``/``run_chunk``/``chunk_round_metrics`` carry the
walker axis, and ``evaluate`` sees the fleet-mean token.

``scenario=`` (a preset name or a ``ScenarioConfig``) attaches the
environment to the trainer, seeded with ``seed``, before the run; the
rounds' ``latency_s`` and ``energy_j`` add up to the result's totals.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .base import TrainerBase, normalize_round_metrics


@dataclasses.dataclass
class SimulationResult:
    algo: str
    history: list[dict]             # eval snapshots (every eval_every)
    round_metrics: list[dict]       # per-round metrics (train loss etc.)
    final: dict                     # last eval snapshot
    total_comm_bytes: int
    wall_time_s: float
    total_latency_s: float = 0.0    # wireless cost totals (0 when the
    total_energy_j: float = 0.0     # trainer prices no scenario comm)

    def curve(self, key: str = "acc") -> tuple[np.ndarray, np.ndarray]:
        """(eval rounds, the snapshots' ``key`` values; NaN where absent)."""
        rounds = np.array([h["round"] for h in self.history])
        vals = np.array([h.get(key, np.nan) for h in self.history])
        return rounds, vals


def _snapshot(trainer, state, rnd: int, total_comm: int,
              history: list[dict], verbose: bool, tag: str) -> None:
    snap = trainer.evaluate(state)
    snap["round"] = rnd
    snap["comm_bytes_total"] = total_comm
    history.append(snap)
    if verbose:
        print(f"[{tag}] round {rnd:4d}  acc={snap['acc']:.4f}  "
              f"comm={total_comm / 1e6:.1f}MB")


def run_simulation(trainer: TrainerBase, *, rounds: int = 100,
                   eval_every: int = 10, seed: int = 0,
                   verbose: bool = False, engine: str = "eager",
                   scenario=None) -> SimulationResult:
    """Run ``rounds`` rounds from ``trainer.init_state(seed)`` with the
    host RNG seeded by ``seed``, in ``scenario`` when given."""
    if scenario is not None:
        trainer.attach_scenario(scenario, seed=seed)
    rng = np.random.default_rng(seed)
    state = trainer.init_state(seed)
    history: list[dict] = []
    round_metrics: list[dict] = []
    total_comm = 0
    t0 = time.perf_counter()
    if engine == "eager":
        for r in range(rounds):
            state, metrics = trainer.round(state, r, rng)
            metrics = normalize_round_metrics(metrics, r)
            total_comm += int(metrics["comm_bytes"])
            round_metrics.append(metrics)
            if (r + 1) % eval_every == 0 or r == rounds - 1:
                _snapshot(trainer, state, r + 1, total_comm, history,
                          verbose, trainer.name)
    else:
        if not hasattr(trainer, "run_chunk"):
            raise ValueError(f"trainer {trainer.name!r} has no scan driver; "
                             "use engine='eager'")
        trainer._engine_use_fused(engine)   # validate before any work
        r = 0
        while r < rounds:
            # Chunks end on eval boundaries, so snapshots land on the
            # same rounds as the eager engine.
            r_next = min(((r // eval_every) + 1) * eval_every, rounds)
            sched = trainer.schedule(r_next - r, rng, start_round=r)
            state, stacked = trainer.run_chunk(state, sched, engine=engine)
            for j, e in enumerate(trainer.chunk_round_metrics(sched, stacked,
                                                              r)):
                entry = normalize_round_metrics(e, r + j)
                total_comm += int(entry["comm_bytes"])
                round_metrics.append(entry)
            r = r_next
            _snapshot(trainer, state, r, total_comm, history, verbose,
                      f"{trainer.name}/{engine}")
    wall = time.perf_counter() - t0
    return SimulationResult(
        algo=trainer.name, history=history, round_metrics=round_metrics,
        final=history[-1] if history else {}, total_comm_bytes=total_comm,
        wall_time_s=wall,
        total_latency_s=float(sum(m.get("latency_s", 0.0)
                                  for m in round_metrics)),
        total_energy_j=float(sum(m.get("energy_j", 0.0)
                                 for m in round_metrics)))
