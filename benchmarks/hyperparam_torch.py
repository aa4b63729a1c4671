"""Paper Fig. 3/4 on the PyTorch port (the twin of
``benchmarks/hyperparam.py``, importing only ``repro_torch``): RWSADMM's
accuracy over β ∈ {0.5, 1, 5, 10, 100} and κ ∈ {1e-4, 1e-3, 1e-2, 0.1}
on MLR.

    PYTHONPATH=src python -m benchmarks.hyperparam_torch [--device cpu]

Runs on ``cuda`` unless ``--device cpu``; rows go to
``results/bench/hyperparam_torch.csv``.
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

BETAS = (0.5, 1.0, 5.0, 10.0, 100.0)
KAPPAS = (0.0001, 0.001, 0.01, 0.1)


def run(rounds: int = 80, out_dir: str = "results/bench",
        device=None) -> list[dict]:
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    data, shape = mnist_like_fed(n_clients=10, n_samples=1500, device=device)
    model = get_model("mlr", shape)
    rows = []
    for param, values in (("beta", BETAS), ("kappa", KAPPAS)):
        for value in values:
            tr = make_trainer("rwsadmm", model, data, device=device,
                              **{param: value})
            res = run_simulation(tr, rounds=rounds, eval_every=rounds,
                                 seed=0)
            rows.append({"param": param, "value": value,
                         "acc": round(100 * res.final["acc"], 2)})
            emit(f"hyper/{param}{value}", res.wall_time_s / rounds * 1e6,
                 f"acc={rows[-1]['acc']}%")
    with open(os.path.join(out_dir, "hyperparam_torch.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=80)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default="results/bench")
    args = ap.parse_args()
    run(args.rounds, args.out_dir, args.device)
