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

``telemetry=`` (a ``repro_torch.telemetry.TelemetryRun``, default None)
records the run: manifest config, per-round ``round`` events, the
walk/zone ``visit`` trace, eval ``snapshot`` events and fenced ``phase``
spans (``init_state`` / ``schedule`` / ``scan_chunk`` / ``ensure`` /
``eval`` / ``round_eager``; on a card with their CUDA-event device time).
Telemetry draws no random numbers and puts nothing into a captured graph;
its fences run only with a run attached, so the off path adds no sync and
telemetry on ≡ off bit for bit. Render a run with ``python -m
repro_torch.telemetry.report runs/<id>``.

On the lazy plane with ``prefetch=True`` the scan driver schedules the
next window while the current one runs and hands its ids to the store's
staging thread; windows are still scheduled strictly in order, so the
run is bit for bit the one without prefetch.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..telemetry import maybe_trace, telemetry_print, \
    visit_events_from_round, visit_events_from_schedule
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
              history: list[dict], verbose: bool, tag: str,
              telemetry=None) -> None:
    with trainer._phase("eval", round=rnd):
        snap = trainer.evaluate(state)
    snap["round"] = rnd
    snap["comm_bytes_total"] = total_comm
    history.append(snap)
    if telemetry is not None:
        telemetry.snapshot(snap)
    if verbose:
        acc = snap.get("acc")
        acc_s = f"acc={acc:.4f}  " if acc is not None else ""
        telemetry_print(f"[{tag}] round {rnd:4d}  {acc_s}"
                        f"comm={total_comm / 1e6:.1f}MB")


def _finalize_telemetry(telemetry, result: SimulationResult) -> None:
    telemetry.counter("total_comm_bytes", result.total_comm_bytes)
    telemetry.counter("total_latency_s", result.total_latency_s)
    telemetry.counter("total_energy_j", result.total_energy_j)
    telemetry.counter("wall_time_s", round(result.wall_time_s, 6))


def _init_state(trainer, seed: int, telemetry):
    with trainer._phase("init_state") as sp:
        state = trainer.init_state(seed)
        if telemetry is not None:
            sp.fence(state)
    return state


def run_simulation(trainer: TrainerBase, *, rounds: int = 100,
                   eval_every: int = 10, seed: int = 0,
                   verbose: bool = False, engine: str = "eager",
                   scenario=None, telemetry=None) -> SimulationResult:
    """Run ``rounds`` rounds from ``trainer.init_state(seed)`` with the
    host RNG seeded by ``seed``, in ``scenario`` when given, recorded
    into ``telemetry`` when given."""
    if scenario is not None:
        trainer.attach_scenario(scenario, seed=seed)
    if telemetry is not None:
        trainer.set_telemetry(telemetry)
        telemetry.update_manifest(config={
            "algo": trainer.name, "engine": engine, "rounds": rounds,
            "eval_every": eval_every, "sim_seed": seed,
            "n_clients": trainer.n_clients,
        })
        if telemetry.manifest.get("seed") is None:
            telemetry.update_manifest(seed=seed)
    if engine != "eager":
        if not hasattr(trainer, "run_chunk"):
            raise ValueError(f"trainer {trainer.name!r} has no scan driver; "
                             "use engine='eager'")
        trainer._engine_use_fused(engine)   # validate before any work
    rng = np.random.default_rng(seed)
    state = _init_state(trainer, seed, telemetry)
    history: list[dict] = []
    round_metrics: list[dict] = []
    total_comm = 0
    t0 = time.perf_counter()
    with maybe_trace(telemetry):
        if engine == "eager":
            for r in range(rounds):
                with trainer._phase("round_eager", round=r):
                    state, metrics = trainer.round(state, r, rng)
                metrics = normalize_round_metrics(metrics, r)
                total_comm += int(metrics["comm_bytes"])
                round_metrics.append(metrics)
                if telemetry is not None:
                    telemetry.round(metrics)
                    for v in visit_events_from_round(metrics):
                        telemetry.visit(**v)
                if (r + 1) % eval_every == 0 or r == rounds - 1:
                    _snapshot(trainer, state, r + 1, total_comm, history,
                              verbose, trainer.name, telemetry)
        else:
            state, total_comm = _run_windows(
                trainer, state, rng, rounds, eval_every, engine, verbose,
                telemetry, history, round_metrics)
    wall = time.perf_counter() - t0
    result = SimulationResult(
        algo=trainer.name, history=history, round_metrics=round_metrics,
        final=history[-1] if history else {}, total_comm_bytes=total_comm,
        wall_time_s=wall,
        total_latency_s=float(sum(m.get("latency_s", 0.0)
                                  for m in round_metrics)),
        total_energy_j=float(sum(m.get("energy_j", 0.0)
                                 for m in round_metrics)))
    if telemetry is not None:
        _finalize_telemetry(telemetry, result)
    return result


def _run_windows(trainer, state, rng, rounds: int, eval_every: int,
                 engine: str, verbose: bool, telemetry, history: list,
                 round_metrics: list):
    """The scan driver: one window per eval interval. With the store's
    prefetch on, the next window is scheduled and its rows staged on the
    host while the current one runs, then fenced."""
    prefetching = (getattr(trainer, "store", None) is not None
                   and trainer.store.prefetch_enabled)
    total_comm = 0
    sched = None
    r = 0
    while r < rounds:
        # Windows end on eval boundaries, so snapshots land on the same
        # rounds as the eager engine.
        r_next = min(((r // eval_every) + 1) * eval_every, rounds)
        if sched is None:   # not handed over by a prefetching window
            with trainer._phase("schedule", round=r,
                                chunk_rounds=r_next - r):
                sched = trainer.schedule(r_next - r, rng, start_round=r)
        sched_next = None
        with trainer._phase("scan_chunk", round=r, engine=engine,
                            chunk_rounds=r_next - r,
                            includes_compile=trainer.chunk_is_cold(
                                engine, r_next - r)) as sp:
            state, stacked = trainer.run_chunk(state, sched, engine=engine)
            if prefetching and r_next < rounds:
                # The window is queued on the device: overlap the next
                # window's host work behind it.
                r_nn = min(((r_next // eval_every) + 1) * eval_every,
                           rounds)
                with trainer._phase("schedule", round=r_next,
                                    chunk_rounds=r_nn - r_next):
                    sched_next = trainer.schedule(r_nn - r_next, rng,
                                                  start_round=r_next)
                trainer.prefetch_chunk(sched_next)
            if telemetry is not None:
                sp.fence()
        entries = [normalize_round_metrics(e, r + j) for j, e in
                   enumerate(trainer.chunk_round_metrics(sched, stacked, r))]
        for entry in entries:
            total_comm += int(entry["comm_bytes"])
            round_metrics.append(entry)
        if telemetry is not None:
            for entry in entries:
                telemetry.round(entry)
            for v in visit_events_from_schedule(sched, r, entries):
                telemetry.visit(**v)
        r = r_next
        sched = sched_next
        _snapshot(trainer, state, r, total_comm, history, verbose,
                  f"{trainer.name}/{engine}", telemetry)
    return state, total_comm
