"""Paper Table 2 / Fig. 7 on the PyTorch port (the twin of
``benchmarks/table2_scaling.py``, importing only ``repro_torch``):
RWSADMM on the MLP with 20, 50 and 100 clients for 8n rounds (visits per
client about constant): personalized accuracy, wall time and the
communication it took.

    PYTHONPATH=src python -m benchmarks.table2_scaling_torch [--device cpu]

Runs on ``cuda`` unless ``--device cpu``; ``--rounds-per-client`` cuts
the 8n rounds. Rows go to ``results/bench/table2_scaling_torch.csv``.
"""
from __future__ import annotations

import argparse
import csv
import os

from repro_torch import resolve_device
from repro_torch.fl.simulation import run_simulation
from repro_torch.models.small import get_model

from .scan_scaling_torch import emit
from .table1_torch import make_trainer, mnist_like_fed


def run(out_dir: str = "results/bench", device=None,
        clients=(20, 50, 100), rounds_per_client: int = 8) -> list[dict]:
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for n in clients:
        data, shape = mnist_like_fed(n_clients=n, n_samples=200 * n,
                                     device=device)
        model = get_model("mlp", shape)
        rounds = rounds_per_client * n
        tr = make_trainer("rwsadmm", model, data, zone=8, device=device)
        res = run_simulation(tr, rounds=rounds, eval_every=rounds, seed=0)
        row = {
            "n_clients": n,
            "rounds": rounds,
            "acc": round(100 * res.final["acc_personalized"], 2),
            "time_s": round(res.wall_time_s, 1),
            "comm_mb": round(res.total_comm_bytes / 1e6, 1),
        }
        rows.append(row)
        emit(f"table2/clients{n}", res.wall_time_s / rounds * 1e6,
             f"acc={row['acc']}% time={row['time_s']}s "
             f"comm={row['comm_mb']}MB")
    with open(os.path.join(out_dir, "table2_scaling_torch.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--clients", type=int, nargs="+", default=[20, 50, 100])
    ap.add_argument("--rounds-per-client", type=int, default=8)
    ap.add_argument("--out-dir", default="results/bench")
    args = ap.parse_args()
    run(args.out_dir, args.device, args.clients, args.rounds_per_client)
