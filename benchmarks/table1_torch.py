"""Paper Table 1 on the PyTorch port: converged accuracy (%) and wall
time per algorithm × dataset × model (the twin of ``benchmarks/table1.py``,
importing only ``repro_torch``). Offline synthetic stand-ins; the claim is
the ORDERING (RWSADMM ≥ personalized baselines ≫ FedAvg under
pathological non-IID), not absolute MNIST digits.

    PYTHONPATH=src python -m benchmarks.table1_torch --rounds 120

The rows run on ``cuda`` unless ``--device cpu``. The baselines and
Walkman step round by round (``engine="eager"``, as the reference); the
RWSADMM rows run the port's scan engines: ``rwsadmm`` on ``scan`` (the
eager trajectory, without host syncs) and ``rwsadmm_cf`` on
``scan_fused``, which sends each round's closed-form zone update through
the CUDA zone kernel.
"""
from __future__ import annotations

import argparse
import csv
import os

from repro_torch import resolve_device
from repro_torch.baselines import REGISTRY, WalkmanTrainer
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.data import build_federated, build_federated_from_pairs, \
    make_image_dataset, make_synthetic_lr, pathological_split
from repro_torch.fl.base import to_device_data
from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer
from repro_torch.fl.simulation import run_simulation
from repro_torch.models.small import get_model

ALGOS = ["fedavg", "perfedavg", "pfedme", "ditto", "apfl", "rwsadmm"]
MODELS = ("mlr", "mlp")
ENGINE = {"rwsadmm": "scan", "rwsadmm_cf": "scan_fused"}


# Copies of benchmarks/common.py's fixtures (that file imports repro).
def mnist_like_fed(n_clients: int = 20, n_samples: int = 3000,
                   seed: int = 0, device=None):
    imgs, labels = make_image_dataset(n_samples, seed=seed)
    idx = pathological_split(labels, n_clients, seed=seed)
    return (to_device_data(build_federated(imgs, labels, idx), device),
            (28, 28, 1))


def synthetic_fed(n_clients: int = 50, seed: int = 0, device=None):
    pairs = make_synthetic_lr(n_clients, seed=seed)
    return to_device_data(build_federated_from_pairs(pairs), device), (60,)


def make_trainer(algo: str, model, data, *, beta: float = 1.0,
                 kappa: float = 0.001, zone: int = 8, seed: int = 0,
                 device=None):
    if algo == "rwsadmm":
        return RWSADMMTrainer(
            model, data,
            RWSADMMHparams(beta=beta, kappa=kappa, epsilon=1e-5),
            zone_size=zone, batch_size=32, seed=seed, device=device)
    if algo == "rwsadmm_cf":
        return RWSADMMTrainer(
            model, data, RWSADMMHparams(beta=10.0, kappa=kappa,
                                        epsilon=1e-5),
            zone_size=zone, solver="closed_form", seed=seed, device=device)
    if algo == "walkman":
        return WalkmanTrainer(model, data, beta=3.0, seed=seed,
                              device=device)
    if algo not in REGISTRY:
        raise ValueError(algo)
    return REGISTRY[algo](model, data,
                          clients_per_round=min(10, data.n_clients),
                          device=device)


def datasets(device=None) -> dict:
    """Table 1's two datasets on ``device``: name → (data, input shape)."""
    return {
        "mnist_like": mnist_like_fed(n_clients=10, n_samples=2000,
                                     device=device),
        "synthetic": synthetic_fed(n_clients=20, device=device),
    }


def run(rounds: int = 120, out_dir: str = "results/bench", device=None,
        algos=ALGOS) -> list[dict]:
    """Every algorithm of ``algos`` on both datasets and both models, each
    for ``rounds`` rounds (Walkman, one client a round, for 4×). Returns
    the rows and writes them to ``out_dir/table1_torch.csv``."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for ds_name, (data, shape) in datasets(device).items():
        for model_name in MODELS:
            model = get_model(model_name, shape)
            for algo in algos:
                tr = make_trainer(algo, model, data, device=device)
                r = rounds if algo != "walkman" else rounds * 4
                res = run_simulation(tr, rounds=r, eval_every=r, seed=0,
                                     engine=ENGINE.get(algo, "eager"))
                final = res.final
                row = {
                    "dataset": ds_name, "model": model_name, "algo": algo,
                    "rounds": r,
                    "acc": round(100 * final["acc"], 2),
                    "acc_global": round(100 * final.get("acc_global", 0.0),
                                        2),
                    "loss": final.get("loss_personalized",
                                      final.get("loss_global")),
                    "time_s": res.wall_time_s,
                    "comm_mb": res.total_comm_bytes / 1e6,
                }
                rows.append(row)
                print(f"table1_torch/{ds_name}/{model_name}/{algo},"
                      f"{res.wall_time_s / r * 1e6:.1f},acc={row['acc']}% "
                      f"comm={row['comm_mb']:.1f}MB", flush=True)
    with open(os.path.join(out_dir, "table1_torch.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--algos", nargs="+", default=ALGOS)
    ap.add_argument("--out-dir", default="results/bench")
    args = ap.parse_args()
    run(args.rounds, args.out_dir, args.device, args.algos)
