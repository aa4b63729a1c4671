"""Scenario sweep on the PyTorch port: accuracy and wireless cost against
mobility and link quality (the twin of ``benchmarks/scenario_sweep.py``,
importing only ``repro_torch``).

Every mobility model × link-dropout setting runs through the
``engine="scan"`` engine (the scenario stays host-side control plane and
compiles into the same fixed-shape windows, captured as CUDA graphs on
the card), reporting final personalized accuracy and the comm model's
latency/energy totals beside bytes. A speedup column re-measures scan
against eager per scenario: the captured window's gain must survive the
scenario's stepping.

CSV rows:

  scenario_sweep/{scenario},{us_per_round},acc=... latency_s=...
      energy_j=... scan_vs_eager=...
  scenario_sweep/dropout_vs_mobility,0.0,... ok=...
  scenario_sweep/speed_{v}, .../sensitivity_{s}   (full mode only)

    PYTHONPATH=src python -m benchmarks.scenario_sweep_torch --smoke
    PYTHONPATH=src python -m benchmarks.scenario_sweep_torch --device cpu \
        --smoke --rounds 5 --speedup-rounds 10 --reps 1

The trainers run on ``cuda`` unless ``--device cpu``. ``us_per_round``
is host wall time per round of the accuracy run (one evaluation
included); ``latency_s`` and ``energy_j`` are the comm model's prices.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer
from repro_torch.fl.simulation import run_simulation
from repro_torch.models.small import get_model
from repro_torch.scenarios import LinkConfig, MobilityConfig, \
    ScenarioConfig, get_scenario_config

from .table1_torch import synthetic_fed

MOBILITY_MODELS = ("static_regen", "random_waypoint", "gauss_markov")


def emit(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_trainer(n_clients: int, scenario, device, seed: int = 0
                 ) -> RWSADMMTrainer:
    data, shape = synthetic_fed(n_clients, seed=seed, device=device)
    return RWSADMMTrainer(
        get_model("mlr", shape), data,
        RWSADMMHparams(beta=10.0, kappa=0.001, epsilon=1e-5),
        zone_size=8, batch_size=20, solver="closed_form",
        scenario=scenario, seed=seed, device=device)


def grid(dropout_settings=(False, True)) -> list[ScenarioConfig]:
    """All mobility models × link-dropout settings."""
    return [ScenarioConfig(name=f"{model}{'+drop' if drop else ''}",
                           mobility=MobilityConfig(model=model),
                           links=LinkConfig(enabled=drop, dropout=drop))
            for model in MOBILITY_MODELS for drop in dropout_settings]


def measure_speedup(n_clients: int, scenario: ScenarioConfig, rounds: int,
                    device, reps: int = 6) -> float:
    """scan against eager rounds/s on this scenario, after a warm-up
    (the window's capture on the card). The engines' timing windows
    interleave rep by rep, each estimate is the best of ``reps``, and a
    scan rep runs three windows with their host ``schedule()``."""
    tr_e = make_trainer(n_clients, scenario, device)
    state_e = tr_e.init_state(0)
    rng_e = np.random.default_rng(0)
    state_e, _ = tr_e.round(state_e, 0, rng_e)
    tr_s = make_trainer(n_clients, scenario, device)
    rng_s = np.random.default_rng(0)
    state_s, _ = tr_s.run_chunk(tr_s.init_state(0),
                                tr_s.schedule(rounds, rng_s), "scan")
    sync(device)
    rates = {"eager": 0.0, "scan": 0.0}
    r_e, r_s, chunks = 1, rounds, 3
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(rounds):
            state_e, _ = tr_e.round(state_e, r_e, rng_e)
            r_e += 1
        sync(device)
        rates["eager"] = max(rates["eager"],
                             rounds / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for _ in range(chunks):
            sched = tr_s.schedule(rounds, rng_s, start_round=r_s)
            r_s += rounds
            state_s, stacked = tr_s.run_chunk(state_s, sched, "scan")
        float(stacked["train_loss"][-1])
        rates["scan"] = max(rates["scan"],
                            chunks * rounds / (time.perf_counter() - t0))
    return rates["scan"] / rates["eager"]


def run(n_clients: int = 20, rounds: int = 150, speedup_rounds: int = 200,
        smoke: bool = False, out_dir: str = "results/bench", device=None,
        reps: int = 6) -> list[dict]:
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    speedups = {cfg.name: measure_speedup(n_clients, cfg, speedup_rounds,
                                          device, reps)
                for cfg in grid()}
    rows = []
    for cfg in grid():
        res = run_simulation(make_trainer(n_clients, cfg, device),
                             rounds=rounds, eval_every=rounds, seed=0,
                             engine="scan")
        speedup = speedups[cfg.name]
        rows.append({
            "scenario": cfg.name,
            "mobility": cfg.mobility.model,
            "link_dropout": int(cfg.links.enabled),
            "final_acc": round(float(res.final["acc_personalized"]), 4),
            "comm_mb": round(res.total_comm_bytes / 1e6, 2),
            "latency_s": round(res.total_latency_s, 3),
            "energy_j": round(res.total_energy_j, 3),
            "scan_vs_eager": round(speedup, 2),
        })
        emit(f"scenario_sweep/{cfg.name}", 1e6 * res.wall_time_s / rounds,
             f"acc={rows[-1]['final_acc']} "
             f"latency_s={rows[-1]['latency_s']} "
             f"energy_j={rows[-1]['energy_j']} "
             f"scan_vs_eager={speedup:.1f}x")
    # The reference's acceptance row: the scan-vs-eager gain under link
    # dropout (which steps the link layer every round) against the pure
    # mobility gain; ok when the ratio is at least 0.9.
    drop = np.mean([r["scan_vs_eager"] for r in rows if r["link_dropout"]])
    pure = np.mean([r["scan_vs_eager"] for r in rows
                    if not r["link_dropout"]])
    emit("scenario_sweep/dropout_vs_mobility", 0.0,
         f"dropout_speedup={drop:.2f}x mobility_speedup={pure:.2f}x "
         f"ratio={drop / pure:.2f} ok={int(drop / pure >= 0.9)}")

    if not smoke:
        base = get_scenario_config("gauss_markov")
        for speed in (0.005, 0.02, 0.08):
            cfg = dataclasses.replace(
                base, name=f"gm_speed{speed}", mobility=dataclasses.replace(
                    base.mobility, mean_speed=speed))
            res = run_simulation(make_trainer(n_clients, cfg, device),
                                 rounds=rounds, eval_every=rounds, seed=0,
                                 engine="scan")
            emit(f"scenario_sweep/speed_{speed}", 0.0,
                 f"acc={res.final['acc_personalized']:.4f} "
                 f"latency_s={res.total_latency_s:.3f}")
        for sens in (-85.0, -75.0, -65.0):   # better → worse radios
            cfg = ScenarioConfig(
                name=f"gm_sens{sens}",
                mobility=MobilityConfig(model="gauss_markov"),
                links=LinkConfig(enabled=True, sensitivity_dbm=sens))
            res = run_simulation(make_trainer(n_clients, cfg, device),
                                 rounds=rounds, eval_every=rounds, seed=0,
                                 engine="scan")
            emit(f"scenario_sweep/sensitivity_{sens}", 0.0,
                 f"acc={res.final['acc_personalized']:.4f} "
                 f"latency_s={res.total_latency_s:.3f} "
                 f"energy_j={res.total_energy_j:.3f}")

    with open(os.path.join(out_dir, "scenario_sweep_torch.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="fewer rounds, no speed/sensitivity sweeps")
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--speedup-rounds", type=int, default=None)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out-dir", default="results/bench")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    rounds = args.rounds or (30 if args.smoke else 150)
    # Windows shorter than ~100 rounds time mostly the per-window fixed
    # cost; keep them longer than the accuracy runs, in smoke mode too.
    speedup_rounds = args.speedup_rounds or (150 if args.smoke else 300)
    run(args.clients, rounds, speedup_rounds, args.smoke, args.out_dir,
        args.device, args.reps)


if __name__ == "__main__":
    main()
