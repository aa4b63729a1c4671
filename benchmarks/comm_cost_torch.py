"""§4 communication comparison on the PyTorch port: bytes to reach a
target accuracy (the twin of ``benchmarks/comm_cost.py``, importing only
``repro_torch``).

RWSADMM's per-round communication is O(1) (the walking token + |S| zone
uploads) against O(m) for the FedAvg family, and its complexity constant
scales with ln²n/(1−λ₂)² (Eq. 30): the rows give both the measured
bytes-to-accuracy and the analytic constant.

Every run attaches the ``lossy_links`` scenario, so the wireless comm
model (``scenarios/links.py``) prices each round in latency and energy
beside bytes: RWSADMM pays short zone-range hops, the FedAvg family
client↔base-station round trips. Latency and energy are the model's
prices (host arithmetic), not times measured on the device.

    PYTHONPATH=src python -m benchmarks.comm_cost_torch
    PYTHONPATH=src python -m benchmarks.comm_cost_torch --device cpu \
        --rounds 10

The trainers run on ``cuda`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import graph as G
from repro_torch.core import markov as M
from repro_torch.fl.simulation import run_simulation
from repro_torch.models.small import get_model

from .table1_torch import make_trainer, mnist_like_fed

ALGOS = ["fedavg", "pfedme", "ditto", "apfl", "rwsadmm"]


def emit(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


def run(target: float = 0.8, rounds: int = 150, out_dir: str = "results/bench",
        device=None, algos=ALGOS) -> list[dict]:
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    data, shape = mnist_like_fed(n_clients=10, n_samples=2000, device=device)
    model = get_model("mlr", shape)
    rows = []
    for algo in algos:
        tr = make_trainer(algo, model, data, zone=4, device=device)
        res = run_simulation(tr, rounds=rounds, eval_every=10, seed=0,
                             scenario="lossy_links")
        rs, accs = res.curve("acc")
        per_round = res.total_comm_bytes / rounds
        hit = next((i for i, a in enumerate(accs) if a >= target), None)
        bytes_to_target = (res.history[hit]["comm_bytes_total"]
                           if hit is not None else -1)
        rows.append({
            "algo": algo,
            "bytes_per_round": int(per_round),
            "bytes_to_{:.0%}".format(target): int(bytes_to_target),
            "latency_s_per_round": round(res.total_latency_s / rounds, 5),
            "energy_j_per_round": round(res.total_energy_j / rounds, 5),
            "final_acc": round(float(accs[-1]), 4),
        })
        emit(f"comm/{algo}", per_round,
             f"to_target={bytes_to_target / 1e6:.1f}MB "
             f"latency_s_per_round={rows[-1]['latency_s_per_round']} "
             f"energy_j_per_round={rows[-1]['energy_j_per_round']} "
             f"final={accs[-1]:.3f}")

    # Analytic complexity constant ln²n/(1−λ₂)² across graph densities.
    for n, deg in ((20, 5), (50, 5), (100, 5), (100, 20)):
        g = G.random_geometric_graph(n, min_degree=deg,
                                     rng=np.random.default_rng(0))
        lam2 = M.lambda2(M.degree_transition_matrix(g))
        const = np.log(n) ** 2 / max(1e-9, (1 - lam2) ** 2)
        emit(f"comm/complexity_n{n}_deg{deg}", 0.0,
             f"lambda2={lam2:.4f} ln2n_over_gap2={const:.1f}")
        rows.append({"algo": f"analytic_n{n}_deg{deg}",
                     "bytes_per_round": 0,
                     "bytes_to_{:.0%}".format(target): 0,
                     "final_acc": round(const, 2)})
    with open(os.path.join(out_dir, "comm_cost_torch.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--target", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out-dir", default="results/bench")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    run(args.target, args.rounds, args.out_dir, args.device)


if __name__ == "__main__":
    main()
