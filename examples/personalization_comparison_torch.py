"""Personalization shoot-out on the PyTorch port (paper Table 1 / Fig. 2,
condensed; the twin of ``examples/personalization_comparison.py``):
RWSADMM against Per-FedAvg, pFedMe, Ditto, APFL and FedAvg on
pathological non-IID data for the strongly convex MLR model. Runs on the
GPU unless asked for the CPU.

Run:  PYTHONPATH=src python examples/personalization_comparison_torch.py \
          [--rounds 200] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.baselines import REGISTRY  # noqa: E402
from repro_torch.core.rwsadmm import RWSADMMHparams  # noqa: E402
from repro_torch.data import build_federated, make_image_dataset, \
    pathological_split  # noqa: E402
from repro_torch.fl.base import to_device_data  # noqa: E402
from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer  # noqa: E402
from repro_torch.fl.simulation import run_simulation  # noqa: E402
from repro_torch.models.small import get_model  # noqa: E402

BASELINES = {"FedAvg": "fedavg", "Per-FedAvg": "perfedavg",
             "pFedMe": "pfedme", "Ditto": "ditto", "APFL": "apfl"}


def main(rounds: int = 200, device=None) -> list[tuple]:
    device = resolve_device(device)
    imgs, labels = make_image_dataset(2500, seed=0)
    parts = pathological_split(labels, 20, seed=0)
    data = to_device_data(build_federated(imgs, labels, parts), device)
    model = get_model("mlr", (28, 28, 1))

    trainers = {name: REGISTRY[algo](model, data, clients_per_round=10,
                                     device=device)
                for name, algo in BASELINES.items()}
    trainers["RWSADMM"] = RWSADMMTrainer(
        model, data, RWSADMMHparams(beta=1.0, kappa=0.001, epsilon=1e-5),
        zone_size=8, batch_size=32, device=device)
    rows = []
    for name, tr in trainers.items():
        res = run_simulation(tr, rounds=rounds, eval_every=rounds, seed=0)
        rows.append((name, res.final["acc"],
                     res.final.get("acc_global", float("nan")),
                     res.wall_time_s, res.total_comm_bytes / 1e6))
    print(f"\n{'algorithm':12s} {'acc':>8s} {'acc_glob':>9s} "
          f"{'time_s':>7s} {'comm_MB':>8s}")
    for name, acc, accg, t, mb in sorted(rows, key=lambda r: -r[1]):
        print(f"{name:12s} {acc:8.4f} {accg:9.4f} {t:7.1f} {mb:8.1f}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.rounds, args.device)
