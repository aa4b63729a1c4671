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

``--control-plane`` runs instead the large-n section: the host's control
plane alone (a 64-round Gauss-Markov rollout with link dropouts on the
sparse neighbor-list backend, the walk, zone planning, keys and pricing;
no training) at n ∈ {2000, 10000, 50000}, the radio range shrinking
with n so the expected degree stays ~12, as the reference's
``benchmarks/common.py::control_plane_rate``. Its rows,
``scan_scaling/control_plane/n{N}/sparse,{us_per_round},peak_rss_mb=...``,
are host time and host memory (stamped ``device: cpu``, the host's
``host_cpu`` model and ``host_of``, the card the machine holds, if any):

    PYTHONPATH=src python -m benchmarks.scan_scaling_torch --control-plane

The ``--lazy`` section waits for the port's lazy plane (ROADMAP Queue 1
item 7).
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import markov
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.fl.rwsadmm_trainer import ENGINES, RWSADMMTrainer
from repro_torch.models.small import get_model
from repro_torch.scenarios import LinkConfig, MobilityConfig, Scenario, \
    ScenarioConfig

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


def reset_peak_rss() -> None:
    """Reset the kernel's peak-RSS watermark (Linux ``clear_refs``), so
    each row records its own peak; where that is refused the peaks only
    grow from row to row (still upper bounds)."""
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
    except OSError:
        pass


def host_cpu() -> str:
    """The host CPU's model name (``/proc/cpuinfo``)."""
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    return "unknown"


def peak_rss_mb() -> float:
    """The process's peak resident set in MB: VmHWM, or ``ru_maxrss``
    (KB on Linux) where the kernel reports no VmHWM; the latter never
    resets, so its rows' peaks only grow."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) / 1024.0
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def control_plane_rate(n: int, rounds: int = 64, *,
                       target_degree: float = 12.0, k_max: int = 32,
                       zone_size: int = 8, rollout_chunk: int = 32,
                       seed: int = 0) -> float:
    """Host seconds per round of the control plane alone: a Gauss-Markov
    scenario with link dropouts on the sparse backend, walked, planned,
    keyed and priced for ``rounds`` rounds in one ``zone_schedule``."""
    radio = float(np.sqrt(target_degree / (np.pi * n)))
    cfg = ScenarioConfig(
        name="bench_gauss_markov_sparse",
        mobility=MobilityConfig(model="gauss_markov", radio_range=radio),
        links=LinkConfig(enabled=True, dropout=True),
        graph_backend="sparse", neighbor_k_max=k_max,
        rollout_chunk=rollout_chunk)
    scenario = Scenario(n, cfg, seed=seed)
    walker = markov.RandomWalkServer(seed=seed + 1)
    walker.reset(scenario.current())
    rng = np.random.default_rng(seed)

    def price(graphs, clients, idx, mask):
        return scenario.price_schedule(graphs, clients, idx, mask, 2048)

    t0 = time.perf_counter()
    markov.zone_schedule(scenario, walker, rounds, zone_size, rng,
                         price=price)
    return (time.perf_counter() - t0) / rounds


def control_plane(clients=(2000, 10000, 50000), rounds: int = 64,
                  out: str = OUT) -> dict:
    """The large-n rows: {n: host seconds per round}."""
    info = {**stamp(torch.device("cpu")), "host_cpu": host_cpu(),
            "host_of": (torch.cuda.get_device_name(0)
                        if torch.cuda.is_available() else None)}
    results, rows = {}, []
    for n in clients:
        reset_peak_rss()
        sec = control_plane_rate(n, rounds=rounds)
        rss = peak_rss_mb()
        name = f"scan_scaling/control_plane/n{n}/sparse"
        emit(name, sec * 1e6,
             f"rounds_per_s={1.0 / sec:.1f} peak_rss_mb={rss:.0f}")
        rows.append({"name": name, "n": n, "K": 1, "engine": "sparse",
                     "rounds": rounds, "us_per_round": sec * 1e6,
                     "peak_rss_mb": rss, **info})
        results[n] = sec
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
    ap.add_argument("--control-plane", action="store_true",
                    help="run only the large-n control-plane rows")
    ap.add_argument("--cp-clients", type=int, nargs="+",
                    default=[2000, 10000, 50000],
                    help="control-plane client counts")
    ap.add_argument("--cp-rounds", type=int, default=64,
                    help="control-plane rollout window")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    if args.control_plane:
        control_plane(tuple(args.cp_clients), args.cp_rounds, args.out)
        return
    run(args.rounds, tuple(args.clients), args.device, args.out)


if __name__ == "__main__":
    main()
