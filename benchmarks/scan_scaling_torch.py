"""Rounds per second of the port's RWSADMM engines at n ∈ {20, 100, 500}
clients (the twin of ``benchmarks/scan_scaling.py``'s engine section,
importing only ``repro_torch``):

  eager      — one round at a time, one host sync per round;
  scan       — a window of R rounds as one CUDA graph replay (a loop on
               the CPU);
  scan_fused — the same with the CUDA zone kernel's update.

Paper's Synthetic(0.5, 0.5) MLR, ``closed_form``, β = 10, κ = 1e-3,
ε = 1e-5, zone 8, batch 20. The scan engines' timed region includes the
host's ``schedule()`` (graphs, walk, zones, keys); each engine is timed
after one untimed pass (the window's capture on the card). Prints CSV
rows ``scan_scaling/n{N}/{engine},{us_per_round},rounds_per_s=...`` and
writes them, stamped with the torch and CUDA versions, the device's name
and power limit, into ``BENCH_torch_scaling.json`` (merged by row name
and device).

    PYTHONPATH=src python -m benchmarks.scan_scaling_torch
    PYTHONPATH=src python -m benchmarks.scan_scaling_torch --device cpu \
        --rounds 10 --clients 20

The large-n control-plane and ``--lazy`` sections wait for the port's
scenarios and lazy plane (ROADMAP Queue 1 items 2 and 7).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.fl.rwsadmm_trainer import ENGINES, RWSADMMTrainer
from repro_torch.models.small import get_model

from .table1_torch import synthetic_fed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "BENCH_torch_scaling.json")
HP = dict(beta=10.0, kappa=0.001, epsilon=1e-5)


def stamp(device: torch.device) -> dict:
    """What a row ran on: torch and CUDA versions, the device's name and
    (on a card) ``nvidia-smi``'s power limit."""
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": "cpu", "power_limit": None}
    if device.type == "cuda":
        out["device"] = torch.cuda.get_device_name(device)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
        out["power_limit"] = smi.stdout.strip().splitlines()[0]
    return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def emit(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


def write_rows(rows: list[dict], out: str) -> None:
    """Merge ``rows`` into ``out`` by (name, device)."""
    old = []
    if os.path.exists(out):
        with open(out) as f:
            old = json.load(f)["rows"]
    keys = {(r["name"], r["device"]) for r in rows}
    merged = [r for r in old if (r["name"], r["device"]) not in keys] + rows
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out + ".tmp", "w") as f:
        json.dump({"rows": merged}, f, indent=1)
    os.replace(out + ".tmp", out)


def make_trainer(n_clients: int, device, seed: int = 0) -> RWSADMMTrainer:
    data, shape = synthetic_fed(n_clients, seed=seed, device=device)
    return RWSADMMTrainer(get_model("mlr", shape), data,
                          RWSADMMHparams(**HP), zone_size=8, batch_size=20,
                          solver="closed_form", seed=seed, device=device)


def bench_engine(trainer, engine: str, rounds: int, y_of) -> float:
    """Rounds per second of ``engine`` after one untimed pass; ``y_of``
    picks the token out of the trainer's state."""
    device = trainer.device
    state = trainer.init_state(0)
    rng = np.random.default_rng(0)
    if engine == "eager":
        state, _ = trainer.round(state, 0, rng)
        sync(device)
        t0 = time.perf_counter()
        for r in range(1, rounds + 1):
            state, _ = trainer.round(state, r, rng)
        float(y_of(state)[0])
    else:
        sched = trainer.schedule(rounds, rng, start_round=0)
        state, _ = trainer.run_chunk(state, sched, engine=engine)
        sync(device)
        t0 = time.perf_counter()
        sched = trainer.schedule(rounds, rng, start_round=rounds)
        state, stacked = trainer.run_chunk(state, sched, engine=engine)
        float(stacked["train_loss"][-1])
    return rounds / (time.perf_counter() - t0)


def run(rounds: int = 200, clients=(20, 100, 500), device=None,
        out: str = OUT) -> dict:
    """Prints CSV rows; returns {n: {engine: rounds_per_s}}."""
    device = resolve_device(device)
    info = stamp(device)
    results, rows = {}, []
    for n in clients:
        per_engine = {}
        for engine in ENGINES:
            rps = bench_engine(make_trainer(n, device), engine, rounds,
                               lambda s: s.server.y)
            per_engine[engine] = rps
            name = f"scan_scaling/n{n}/{engine}"
            emit(name, 1e6 / rps, f"rounds_per_s={rps:.1f}")
            rows.append({"name": name, "n": n, "K": 1, "engine": engine,
                         "rounds": rounds, "us_per_round": 1e6 / rps,
                         **info})
        emit(f"scan_scaling/n{n}/speedup", 0.0,
             f"scan_vs_eager={per_engine['scan'] / per_engine['eager']:.1f}x"
             f" scan_fused_vs_eager="
             f"{per_engine['scan_fused'] / per_engine['eager']:.1f}x")
        results[n] = per_engine
    write_rows(rows, out)
    return results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=200,
                    help="timed rounds per engine (after one untimed pass)")
    ap.add_argument("--clients", type=int, nargs="+", default=[20, 100, 500])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=OUT, help="rows file (JSON)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    run(args.rounds, tuple(args.clients), args.device, args.out)


if __name__ == "__main__":
    main()
