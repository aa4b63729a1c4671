"""Fleet round throughput of the port for K ∈ {1, 3, 5} walkers, both
fleet modes, eager against the scan engines (the twin of
``benchmarks/fleet_scaling.py``, importing only ``repro_torch``), and
the fleet hitting time (wall steps until the walkers' visits cover every
client) beside a single walker's.

  roundrobin   — one zone a round, the walkers taking turns;
  simultaneous — K zones a wall step through the multi-zone kernel.

The scan engines' timed region includes ``schedule()``; each engine is
timed after one untimed pass (the window's capture on the card). Prints
``fleet_scaling/{mode}/n{N}/K{K}/{engine},{us_per_round},rounds_per_s=...``
and writes the rows, stamped like ``scan_scaling_torch``'s, into
``BENCH_torch_scaling.json``.

    PYTHONPATH=src python -m benchmarks.fleet_scaling_torch
    PYTHONPATH=src python -m benchmarks.fleet_scaling_torch --device cpu \
        --rounds 10 --clients 20
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.fl.fleet_trainer import FleetRWSADMMTrainer
from repro_torch.fl.rwsadmm_trainer import ENGINES
from repro_torch.models.small import get_model

from .scan_scaling_torch import HP, OUT, bench_engine, emit, stamp, \
    write_rows
from .table1_torch import synthetic_fed


def make_fleet(n_clients: int, k: int, mode: str, device,
               seed: int = 0) -> FleetRWSADMMTrainer:
    data, shape = synthetic_fed(n_clients, seed=seed, device=device)
    return FleetRWSADMMTrainer(
        get_model("mlr", shape), data, RWSADMMHparams(**HP), n_walkers=k,
        sync_every=10, fleet_mode=mode, zone_size=8, batch_size=20,
        solver="closed_form", seed=seed, device=device)


def hitting_times(n_clients: int, walkers=(1, 3, 5), rounds: int = 4000,
                  device=None) -> dict:
    """Fleet wall-step hitting time against K: the walkers stepped
    through the graph schedule alone, with no training rounds."""
    out = {}
    for k in walkers:
        fleet = make_fleet(n_clients, k, "simultaneous", device)
        graphs = fleet.dyn_graph.schedule(rounds, include_current=True)
        for w in fleet.walkers:
            w.walk_schedule(graphs[1:], advance_first=True)
        out[k] = fleet.fleet_hitting_time()
        emit(f"fleet_scaling/hitting_time/n{n_clients}/K{k}", 0.0,
             f"wall_steps={out[k]}")
    return out


def run(rounds: int, clients, walkers, modes, device=None,
        out: str = OUT) -> dict:
    device = resolve_device(device)
    info = stamp(device)
    results, rows = {}, []
    for mode in modes:
        for n in clients:
            for k in walkers:
                per_engine = {}
                for engine in ENGINES:
                    rps = bench_engine(make_fleet(n, k, mode, device),
                                       engine, rounds,
                                       lambda s: s.base.server.y)
                    per_engine[engine] = rps
                    name = f"fleet_scaling/{mode}/n{n}/K{k}/{engine}"
                    emit(name, 1e6 / rps, f"rounds_per_s={rps:.1f}")
                    rows.append({"name": name, "n": n, "K": k,
                                 "engine": engine, "mode": mode,
                                 "rounds": rounds,
                                 "us_per_round": 1e6 / rps, **info})
                emit(f"fleet_scaling/{mode}/n{n}/K{k}/speedup", 0.0,
                     f"scan_vs_eager="
                     f"{per_engine['scan'] / per_engine['eager']:.1f}x "
                     f"scan_fused_vs_eager="
                     f"{per_engine['scan_fused'] / per_engine['eager']:.1f}x")
                results[(mode, n, k)] = per_engine
    write_rows(rows, out)
    return results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=200,
                    help="timed rounds per engine (after one untimed pass)")
    ap.add_argument("--clients", type=int, nargs="+", default=[100])
    ap.add_argument("--walkers", type=int, nargs="+", default=[1, 3, 5])
    ap.add_argument("--modes", nargs="+",
                    default=["roundrobin", "simultaneous"])
    ap.add_argument("--hitting-rounds", type=int, default=4000)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=OUT, help="rows file (JSON)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    run(args.rounds, tuple(args.clients), tuple(args.walkers),
        tuple(args.modes), args.device, args.out)
    hitting_times(max(args.clients), tuple(args.walkers),
                  args.hitting_rounds, args.device)


if __name__ == "__main__":
    main()
