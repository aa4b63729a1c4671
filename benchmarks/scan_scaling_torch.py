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

``--lazy`` runs instead full training rounds at n up to 10⁶ on the lazy
client plane (the twin of the reference's ``lazy_plane``, with its
config): the bounded LRU store (``store_capacity`` 1024) holding client
rows on the card, dataset rows drawn on demand from the per-client-seeded
Synthetic(α, β) factory (``min_samples`` 20, ``mean_samples`` 2.0, MLR on
60 features), a Gauss-Markov scenario with link dropouts on the sparse
backend (``neighbor_k_max`` 32, ``rollout_chunk`` 8, radio range for an
expected degree of 12), ``closed_form``, β = 10, κ = 0.001, ε = 1e-5,
zone 8, batch 20, the ``scan`` engine. Each n runs a warm-up window (the
capture) and two timed windows of ``--lazy-rounds`` rounds each
(``--lazy-capacity`` resident slots), pipelined as
``run_simulation`` drives them (schedule, ensure, replay; with
``--prefetch`` the next window is scheduled and its rows staged behind
this one). Rows ``scan_scaling/lazy_plane/n{N}/scan[_prefetch]`` carry µs a
round, peak RSS (MB) and peak device memory (MB), the store's residency
and counters, stamped as the others:

    PYTHONPATH=src python -m benchmarks.scan_scaling_torch --lazy \
        --lazy-clients 100000 1000000 --lazy-rounds 4

``--lazy-check`` (what ``chip_smoke.py`` runs at n = 100,000): two windows
of 8 rounds of ``scan_fused`` with prefetch off and on, which must agree
bit for bit, and one of ``scan``; every window's host columns held by
``==`` against a CPU trainer's ``schedule()``; prints one JSON line with
the timings, peak device memory and peak RSS.
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
from repro_torch.data import synthetic_lr_factory
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


def rss_mb() -> float:
    """The process's resident set now, in MB (VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


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


#: the reference's lazy-plane workload (``benchmarks/scan_scaling.py``)
LAZY = dict(capacity=1024, min_samples=20, mean_samples=2.0, k_max=32,
            rollout_chunk=8, target_degree=12.0)
#: the host columns a lazy window must share with the CPU's schedule()
HOST_COLUMNS = ("client", "zone", "n_i", "latency_s", "energy_j",
                "staleness_p50", "staleness_max", "comm_bytes")


def lazy_trainer(n: int, device, *, capacity: int = LAZY["capacity"],
                 prefetch: bool = False, seed: int = 0) -> RWSADMMTrainer:
    """The lazy-plane cell: ``n`` clients of per-client-seeded
    Synthetic(α, β) behind a ``capacity``-slot store, Gauss-Markov
    mobility with link dropouts on the sparse backend."""
    factory = synthetic_lr_factory(n_clients=n, seed=seed,
                                   min_samples=LAZY["min_samples"],
                                   mean_samples=LAZY["mean_samples"])
    radio = float(np.sqrt(LAZY["target_degree"] / (np.pi * n)))
    cfg = ScenarioConfig(
        name="bench_lazy_gm_sparse",
        mobility=MobilityConfig(model="gauss_markov", radio_range=radio),
        links=LinkConfig(enabled=True, dropout=True),
        graph_backend="sparse", neighbor_k_max=LAZY["k_max"],
        rollout_chunk=LAZY["rollout_chunk"])
    return RWSADMMTrainer(get_model("mlr", (60,)), factory,
                          RWSADMMHparams(**HP), zone_size=8, batch_size=20,
                          solver="closed_form", scenario=cfg, seed=seed,
                          store_capacity=capacity, prefetch=prefetch,
                          device=device)


def lazy_windows(trainer, windows: int, rounds: int, engine: str,
                 seed: int = 0) -> dict:
    """``windows`` windows of ``rounds`` rounds from a fresh state, as
    ``run_simulation``'s scan driver runs them (with the store's prefetch
    on, the next window is scheduled and staged behind this one), each
    ending in a device sync. Returns each window's host seconds (its
    ``schedule()``, wherever it ran, plus its ``run_chunk`` to the sync),
    the round metrics (``chunk_round_metrics``) and the final state."""
    device = trainer.device
    state = trainer.init_state(seed)
    rng = np.random.default_rng(seed)
    prefetch = trainer.store.prefetch_enabled
    plan_s = [0.0] * windows
    seconds, entries, sched = [], [], None

    def plan(w):
        t0 = time.perf_counter()
        out = trainer.schedule(rounds, rng, start_round=w * rounds)
        plan_s[w] = time.perf_counter() - t0
        return out
    for w in range(windows):
        if sched is None:
            sched = plan(w)
        t0 = time.perf_counter()
        state, stacked = trainer.run_chunk(state, sched, engine=engine)
        nxt, ahead = None, 0.0
        if prefetch and w + 1 < windows:   # behind this window's work
            t1 = time.perf_counter()
            nxt = plan(w + 1)
            trainer.prefetch_chunk(nxt)
            ahead = time.perf_counter() - t1
        losses = stacked["train_loss"].cpu()
        sync(device)
        seconds.append(plan_s[w] + time.perf_counter() - t0 - ahead)
        entries += trainer.chunk_round_metrics(
            sched, {"train_loss": losses, "kappa": stacked["kappa"]},
            w * rounds)
        sched = nxt
    return {"seconds": seconds, "entries": entries, "state": state}


def _peak_device_mb(device) -> float | None:
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**20


def _reset_peaks(device) -> None:
    reset_peak_rss()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def lazy_plane(clients=(100_000, 1_000_000), rounds: int = 32,
               capacity: int = LAZY["capacity"], prefetch: bool = False,
               device=None, out: str = OUT) -> dict:
    """The lazy-plane rows of the ``scan`` engine: {n: seconds a round}
    over two timed windows after the warm-up window."""
    device = resolve_device(device)
    info = stamp(device)
    results, rows, engine = {}, [], "scan"
    for n in clients:
        _reset_peaks(device)
        t0 = time.perf_counter()
        trainer = lazy_trainer(n, device, capacity=capacity,
                               prefetch=prefetch)
        setup_s = time.perf_counter() - t0
        setup_rss = rss_mb()
        run = lazy_windows(trainer, 3, rounds, engine)
        sec = sum(run["seconds"][1:]) / (2 * rounds)
        c = trainer.store.counters
        rss, dev_mb = peak_rss_mb(), _peak_device_mb(device)
        tag = engine + ("_prefetch" if prefetch else "")
        name = f"scan_scaling/lazy_plane/n{n}/{tag}"
        emit(name, sec * 1e6,
             f"rounds_per_s={1.0 / sec:.3f} peak_rss_mb={rss:.0f} "
             f"peak_device_mb={dev_mb} "
             f"resident={trainer.store.n_resident}/{capacity} "
             f"miss={c['misses']} evict={c['evictions']} "
             f"restore={c['restores']}")
        rows.append({"name": name, "n": n, "K": 1, "engine": engine,
                     "rounds": 3 * rounds, "timed_rounds": 2 * rounds,
                     "us_per_round": sec * 1e6,
                     "warmup_window_s": run["seconds"][0],
                     "setup_s": setup_s, "capacity": capacity,
                     "peak_rss_mb": rss, "setup_rss_mb": setup_rss,
                     "peak_device_mb": dev_mb,
                     "resident": trainer.store.n_resident,
                     **{f"store_{k}": v for k, v in c.items()},
                     "host_cpu": host_cpu(), **info})
        results[n] = sec
        del trainer, run
    write_rows(rows, out)
    return results


def lazy_check(n: int = 100_000, rounds: int = 8, windows: int = 2,
               device=None) -> dict:
    """The smoke's lazy-plane cell: ``scan_fused`` with prefetch off and
    on (bit for bit equal, state and metrics), ``scan``, and every
    window's host columns against a CPU trainer's ``schedule()``. Raises on a
    mismatch; returns the timings and memory peaks."""
    device = resolve_device(device)
    out = {"n": n, "rounds": rounds, "windows": windows, **stamp(device)}
    runs = {}
    for label, engine, prefetch, count in (
            ("scan_fused", "scan_fused", False, windows),
            ("scan_fused_prefetch", "scan_fused", True, windows),
            ("scan", "scan", False, 1)):
        _reset_peaks(device)
        trainer = lazy_trainer(n, device, prefetch=prefetch)
        runs[label] = run = lazy_windows(trainer, count, rounds, engine)
        steady = run["seconds"][1:] or run["seconds"]
        out[label] = {
            "window_s": run["seconds"],
            "us_per_round": sum(steady) / (len(steady) * rounds) * 1e6,
            "peak_device_mb": _peak_device_mb(device),
            "peak_rss_mb": peak_rss_mb(), "rss_mb": rss_mb(),
            "counters": dict(trainer.store.counters),
            "resident": trainer.store.n_resident,
            "captured": {str(k): w.captured
                         for k, w in trainer.windows.items()}}
    off, on = runs["scan_fused"], runs["scan_fused_prefetch"]
    state_equal = all(torch.equal(a, b) for a, b in zip(
        (off["state"].clients.x, off["state"].clients.z,
         off["state"].server.y, off["state"].visited),
        (on["state"].clients.x, on["state"].clients.z,
         on["state"].server.y, on["state"].visited)))
    # Every window's host columns from a CPU trainer's schedule().
    cpu = lazy_trainer(n, torch.device("cpu"))
    rng, zeros, planned = np.random.default_rng(0), torch.zeros(rounds), []
    for w in range(windows):
        planned += cpu.chunk_round_metrics(
            cpu.schedule(rounds, rng, start_round=w * rounds),
            {"train_loss": zeros, "kappa": zeros}, w * rounds)

    def host(entries):
        return [{k: e[k] for k in HOST_COLUMNS} for e in entries]
    out["checks"] = {
        "prefetch on equals off": off["entries"] == on["entries"]
        and state_equal,
        "host columns equal the CPU schedule's":
            host(off["entries"]) == host(planned)
            and host(runs["scan"]["entries"]) == host(planned)[:rounds],
        "prefetch staged rows":
            out["scan_fused_prefetch"]["counters"]["prefetch_hits"] > 0,
        "losses finite": all(np.isfinite(e["train_loss"])
                             for r in runs.values() for e in r["entries"]),
    }
    if not all(out["checks"].values()):
        raise AssertionError(f"lazy check at n = {n}: {out['checks']}")
    return out


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
    ap.add_argument("--lazy", action="store_true",
                    help="run only the lazy client-plane training rows")
    ap.add_argument("--lazy-clients", type=int, nargs="+",
                    default=[100_000, 1_000_000],
                    help="lazy-plane client counts")
    ap.add_argument("--lazy-rounds", type=int, default=32,
                    help="rounds per lazy-plane window")
    ap.add_argument("--lazy-capacity", type=int, default=LAZY["capacity"],
                    help="lazy plane: the store's resident slots")
    ap.add_argument("--prefetch", action="store_true",
                    help="lazy plane: stage each next window's rows")
    ap.add_argument("--lazy-check", action="store_true",
                    help="the smoke's lazy cell: checks, one JSON line")
    args = ap.parse_args()
    if args.lazy_check:
        print(json.dumps(lazy_check(args.lazy_clients[0], args.lazy_rounds,
                                    device=args.device)), flush=True)
        return
    print("name,us_per_call,derived")
    if args.control_plane:
        control_plane(tuple(args.cp_clients), args.cp_rounds, args.out)
        return
    if args.lazy:
        lazy_plane(tuple(args.lazy_clients), args.lazy_rounds,
                   args.lazy_capacity, args.prefetch, args.device, args.out)
        return
    run(args.rounds, tuple(args.clients), args.device, args.out)


if __name__ == "__main__":
    main()
