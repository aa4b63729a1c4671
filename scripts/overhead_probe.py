"""Where the telemetry overhead twin's pair-to-pair spread comes from:
the same interleaved off/on pairs as
``benchmarks.telemetry_overhead_torch.measure``, each arm read on three
clocks at once (wall, the process's CPU time, the calling thread's CPU
time).

    python3 scripts/overhead_probe.py [--pairs 30] [--rounds 32]
        [--clients 2000] [--cuda]

``--cuda`` first makes a CUDA context and runs one matmul on the card,
as ``chip_smoke.py``'s process holds one when it reaches the twin. For
each clock it prints the pairs' on/off ratios less one, their spread,
and the median over the first 10, 20 and all pairs; then one JSON line.
A wall spread well above the CPU clocks' says the host took the time
from the process (other work on a shared host), not the arms' own work.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCKS = ("wall", "process", "thread")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=32)
    ap.add_argument("--clients", type=int, default=2000)
    ap.add_argument("--cuda", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, os.path.join(HERE, "src")]
    from benchmarks import telemetry_overhead_torch as bench
    from repro_torch.telemetry import TelemetryRun

    if args.cuda:
        import torch

        a = torch.randn(4096, 4096, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
        (a @ a).sum().item()
    # _run_once reads bench.time.perf_counter; all three clocks at once
    bench.time = types.SimpleNamespace(perf_counter=lambda: np.array(
        [time.perf_counter(), time.process_time(), time.thread_time()]))
    n, rounds, zone = args.clients, args.rounds, 8
    bench._run_once(n, rounds, zone, None)          # untimed first run
    off, on = [], []
    with tempfile.TemporaryDirectory() as td:
        for rep in range(args.pairs):
            for arm in ("off", "on") if rep % 2 == 0 else ("on", "off"):
                if arm == "off":
                    off.append(bench._run_once(n, rounds, zone, None,
                                               seed=rep)[0])
                    continue
                with TelemetryRun(f"{td}/run{rep}", seed=rep,
                                  config={"bench": "probe"}) as tel:
                    on.append(bench._run_once(n, rounds, zone, tel,
                                              seed=rep)[0])
    off, on = np.array(off), np.array(on)           # (pairs, clock)
    pct = (on / off - 1.0) * 100.0
    out = {"pairs": args.pairs, "rounds": rounds, "cuda": args.cuda}
    for c, name in enumerate(CLOCKS):
        p = pct[:, c]
        row = {"off_us": float(np.median(off[:, c])) * 1e6,
               "arm_cv_pct": float(np.std(off[:, c]) / np.mean(off[:, c])
                                   * 100.0),
               "pair_sd_pct": float(np.std(p)),
               "median_10": float(np.median(p[:10])),
               "median_20": float(np.median(p[:20])),
               "median_all": float(np.median(p)),
               "pair_pct": [round(float(x), 2) for x in p]}
        out[name] = row
        print(f"{name}: off {row['off_us']:.0f} µs a round (arms' cv "
              f"{row['arm_cv_pct']:.2f} %), pairs' sd {row['pair_sd_pct']:.2f}"
              f" %, medians over 10/20/{args.pairs} pairs "
              f"{row['median_10']:+.2f}/{row['median_20']:+.2f}/"
              f"{row['median_all']:+.2f} %; pairs {row['pair_pct']}",
              flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
