"""Paper Fig. 2 (and App. D.4/D.5) on the PyTorch port (the twin of
``benchmarks/convergence.py``, importing only ``repro_torch``): test
accuracy every 10 rounds for RWSADMM and the baselines on MLR and MLP,
with the rounds each needs to reach 90 % of its final accuracy.

    PYTHONPATH=src python -m benchmarks.convergence_torch [--device cpu]

Runs on ``cuda`` unless ``--device cpu``; the curves go to
``results/bench/convergence_torch.csv``.
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

ALGOS = ["fedavg", "perfedavg", "pfedme", "ditto", "apfl", "rwsadmm"]


def run(rounds: int = 100, out_dir: str = "results/bench",
        device=None) -> dict:
    """``(model, algo) → (eval rounds, accuracies)`` and the CSV."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    data, shape = mnist_like_fed(n_clients=10, n_samples=2000, device=device)
    curves = {}
    for model_name in ("mlr", "mlp"):
        model = get_model(model_name, shape)
        for algo in ALGOS:
            tr = make_trainer(algo, model, data, device=device)
            res = run_simulation(tr, rounds=rounds, eval_every=10, seed=0)
            rs, accs = res.curve("acc")
            curves[(model_name, algo)] = (rs, accs)
            target = 0.9 * accs[-1]
            hit = next((int(r) for r, a in zip(rs, accs) if a >= target),
                       rounds)
            emit(f"convergence/{model_name}/{algo}",
                 res.wall_time_s / rounds * 1e6,
                 f"final_acc={accs[-1]:.4f} rounds_to_90pct={hit}")
    with open(os.path.join(out_dir, "convergence_torch.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["model", "algo", "round", "acc"])
        for (model_name, algo), (rs, accs) in curves.items():
            for r, a in zip(rs, accs):
                w.writerow([model_name, algo, int(r), float(a)])
    return curves


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default="results/bench")
    args = ap.parse_args()
    run(args.rounds, args.out_dir, args.device)
