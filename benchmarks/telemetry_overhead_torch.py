"""Telemetry overhead gate of the port: recording stays within 5 % a round
(the twin of ``benchmarks/telemetry_overhead.py``, importing only
``repro_torch``).

Times the n = 2,000 control plane (Gauss-Markov mobility with link
dropouts on the sparse backend, the walk, zone planning, keys and
pricing; the workload of ``scan_scaling/control_plane/n2000/sparse``)
telemetry off and on (the schedule's span, the scenario's rollout span
and the full per-visit walk trace streamed to ``events.jsonl``), after
one untimed run, in ``--repeats`` interleaved pairs: the two arms of a
pair run one seed, one after the other, each arm first in turn. The
overhead is the median of the pairs' on/off ratios, less one: a pair's
two runs share the host's state of the moment, and the median drops the
pairs that a burst of other work on a shared host hit (best-of-four
minima read −18 % to +13 % from call to call there). The gate reads that
estimate. The recorded arm's trace alone (the visit events built and
streamed) over the unrecorded round is printed beside it. Both rows go
into ``BENCH_torch_scaling.json`` (host time, stamped with the host's CPU
and the card the machine holds, as the control-plane rows):

    telemetry_overhead/control_plane/n2000/{off,on}

    PYTHONPATH=src python -m benchmarks.telemetry_overhead_torch [--smoke]
        [--clients 2000] [--rounds 64] [--repeats 10]
        [--assert-overhead-pct 5.0]

``--assert-overhead-pct`` fails the run when the overhead exceeds it
(default 5; negative disables).
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import markov
from repro_torch.core.markov import RandomWalkServer
from repro_torch.scenarios import LinkConfig, MobilityConfig, Scenario, \
    ScenarioConfig
from repro_torch.telemetry import TelemetryRun, visit_events_from_schedule

from .scan_scaling_torch import OUT, emit, host_cpu, stamp, write_rows


def _build(n: int, seed: int = 0):
    radio = float(np.sqrt(12.0 / (np.pi * n)))
    cfg = ScenarioConfig(
        name="telemetry_overhead",
        mobility=MobilityConfig(model="gauss_markov", radio_range=radio),
        links=LinkConfig(enabled=True, dropout=True),
        graph_backend="sparse", neighbor_k_max=32)
    scenario = Scenario(n, cfg, seed=seed)
    walker = RandomWalkServer(seed=seed + 1)
    walker.reset(scenario.current())
    return scenario, walker


def _run_once(n: int, rounds: int, zone: int, tel: TelemetryRun | None,
              seed: int = 0) -> tuple[float, float]:
    """Seconds a round of the control plane's schedule, recorded or not
    (the schedule's span and the per-visit trace: what telemetry adds to
    a window's host work), and of the trace alone (0 unrecorded)."""
    scenario, walker = _build(n, seed)
    scenario.telemetry = tel
    rng = np.random.default_rng(seed)

    def price(graphs, clients, idx, mask):
        return scenario.price_schedule(graphs, clients, idx, mask, 2048)

    t0 = time.perf_counter()
    if tel is None:
        markov.zone_schedule(scenario, walker, rounds, zone, rng, price=price)
        return (time.perf_counter() - t0) / rounds, 0.0
    with tel.phase("schedule", chunk_rounds=rounds):
        sched = markov.zone_schedule(scenario, walker, rounds, zone, rng,
                                     price=price)
    t1 = time.perf_counter()
    for v in visit_events_from_schedule(sched, 0):
        tel.visit(**v)
    t2 = time.perf_counter()
    return (t2 - t0) / rounds, (t2 - t1) / rounds


def measure(n: int = 2000, rounds: int = 64, zone: int = 8,
            repeats: int = 10, out: str = OUT) -> dict:
    """Over ``repeats`` interleaved pairs: the median µs a round off and
    on, the median of the pairs' on/off ratios less one (``overhead_pct``,
    with each pair's in ``pair_pct``) and the trace's own cost over the
    unrecorded round (``trace_pct``); the two rows are written to
    ``out``."""
    def recorded(rep: int) -> tuple[float, float]:
        with tempfile.TemporaryDirectory() as td:
            with TelemetryRun(td + "/run", seed=rep,
                              config={"bench": "telemetry_overhead",
                                      "n": n}) as tel:
                return _run_once(n, rounds, zone, tel, seed=rep)

    _run_once(n, rounds, zone, None)   # untimed: the process's first run
    off, on, trace = [], [], []
    for rep in range(repeats):
        # Each arm first in turn: the second run of a pair reuses the
        # memory the first freed and reads faster.
        for arm in ("off", "on") if rep % 2 == 0 else ("on", "off"):
            if arm == "off":
                off.append(_run_once(n, rounds, zone, None, seed=rep)[0])
            else:
                sec, tr = recorded(rep)
                on.append(sec)
                trace.append(tr)
    off, on, trace = np.array(off), np.array(on), np.array(trace)
    pair_pct = (on / off - 1.0) * 100.0
    pct = float(np.median(pair_pct))
    trace_pct = float(np.median(trace / off)) * 100.0
    off_s, on_s = float(np.median(off)), float(np.median(on))
    info = {**stamp(torch.device("cpu")), "host_cpu": host_cpu(),
            "host_of": (torch.cuda.get_device_name(0)
                        if torch.cuda.is_available() else None)}
    name = f"telemetry_overhead/control_plane/n{n}"
    emit(f"{name}/off", off_s * 1e6, "us_per_round")
    emit(f"{name}/on", on_s * 1e6,
         f"overhead={pct:+.2f}% trace={trace_pct:.3f}%")
    write_rows([
        {"name": f"{name}/off", "n": n, "K": 1, "engine": "sparse",
         "rounds": rounds, "pairs": repeats, "us_per_round": off_s * 1e6,
         **info},
        {"name": f"{name}/on", "n": n, "K": 1, "engine": "sparse",
         "rounds": rounds, "pairs": repeats, "us_per_round": on_s * 1e6,
         "overhead_pct": pct, "pair_pct": pair_pct.tolist(),
         "trace_us_per_round": float(np.median(trace)) * 1e6,
         "trace_pct": trace_pct, **info}], out)
    return {"n": n, "pairs": repeats, "off_us": off_s * 1e6,
            "on_us": on_s * 1e6, "overhead_pct": pct,
            "pair_pct": pair_pct.tolist(), "trace_pct": trace_pct}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--zone", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=10,
                    help="interleaved off/on pairs")
    ap.add_argument("--smoke", action="store_true",
                    help="small fast run (n = 400, 2 repeats)")
    ap.add_argument("--out", default=OUT, help="rows file (JSON)")
    ap.add_argument("--assert-overhead-pct", type=float, default=5.0,
                    help="fail when telemetry overhead exceeds this "
                         "(negative disables)")
    args = ap.parse_args(argv)
    n, repeats = args.clients, args.repeats
    if args.smoke:
        n, repeats = min(n, 400), min(repeats, 2)
    res = measure(n, args.rounds, args.zone, repeats, args.out)
    if 0 <= args.assert_overhead_pct < res["overhead_pct"]:
        raise SystemExit(f"telemetry overhead {res['overhead_pct']:.2f}% "
                         f"exceeds {args.assert_overhead_pct}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
