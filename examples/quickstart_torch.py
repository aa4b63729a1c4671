"""Quickstart on the PyTorch port: mobilized personalized FL with RWSADMM
(paper Algorithm 1), the twin of ``examples/quickstart.py``.

Trains the paper's MLP on an offline synthetic MNIST-shaped dataset with
a pathological non-IID split (2 labels per client), a dynamic client
graph, and a random-walking mobile server — then compares against FedAvg.
Runs on the GPU unless asked for the CPU.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.baselines import FedAvgTrainer  # noqa: E402
from repro_torch.core.rwsadmm import RWSADMMHparams  # noqa: E402
from repro_torch.data import build_federated, make_image_dataset, \
    pathological_split  # noqa: E402
from repro_torch.fl.base import to_device_data  # noqa: E402
from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer  # noqa: E402
from repro_torch.fl.simulation import run_simulation  # noqa: E402
from repro_torch.models.small import get_model  # noqa: E402


def main(rounds: int = 300, device=None):
    device = resolve_device(device)
    # 1. Offline dataset + the paper's non-IID partition (§5).
    imgs, labels = make_image_dataset(3000, seed=0)
    parts = pathological_split(labels, n_clients=20, labels_per_client=2,
                               seed=0)
    fed = build_federated(imgs, labels, parts)   # 75/25 local splits
    data = to_device_data(fed, device)
    model = get_model("mlp", (28, 28, 1))

    # 2. RWSADMM: mobile server + hard-constraint personalization.
    # engine="scan" precomputes each eval window's walk and runs it with
    # no host sync inside (same trajectory as engine="eager").
    trainer = RWSADMMTrainer(
        model, data,
        RWSADMMHparams(beta=1.0, kappa=0.001, epsilon=1e-5),
        zone_size=8, batch_size=32, min_degree=5, regen_every=10,
        device=device,
    )
    print("== RWSADMM (mobile server, personalized) ==")
    res = run_simulation(trainer, rounds=rounds, eval_every=50,
                         verbose=True, engine="scan")

    # 3. FedAvg benchmark on the same data.
    print("== FedAvg (stationary server, consensus) ==")
    fed_res = run_simulation(
        FedAvgTrainer(model, data, clients_per_round=10, device=device),
        rounds=rounds, eval_every=100, verbose=True,
    )

    print("\nFinal personalized accuracy (RWSADMM): "
          f"{res.final['acc_personalized']:.4f} "
          f"± {res.final['acc_personalized_std']:.4f}")
    print(f"Final global accuracy (FedAvg):         "
          f"{fed_res.final['acc_global']:.4f}")
    print(f"RWSADMM comm/round: "
          f"{res.total_comm_bytes / rounds / 1e6:.2f} MB  |  FedAvg: "
          f"{fed_res.total_comm_bytes / rounds / 1e6:.2f} MB")
    server = trainer.walker
    print(f"server visits: min={server.visit_counts.min()} "
          f"max={server.visit_counts.max()} "
          f"hitting_time={server.hitting_time()}")
    return res, fed_res, trainer


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.rounds, args.device)
