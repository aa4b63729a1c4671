"""The paper-fidelity ablations on the PyTorch port (the twin of
``benchmarks/ablations.py``, importing only ``repro_torch``):

  * the iterative prox-SGD solver (Eq. 9) against the closed form (Eq. 10),
  * Walkman's consensus against RWSADMM's hard-constraint personalization,
  * the Metropolis transition matrix against the degree chain,
  * the literal Eq. (11) (sign-folded gradient), whose first step from
    Eq. 32's initialization moves nothing.

    PYTHONPATH=src python -m benchmarks.ablations_torch [--device cpu]

Runs on ``cuda`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import rwsadmm
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer
from repro_torch.fl.simulation import run_simulation
from repro_torch.models.small import get_model

from .scan_scaling_torch import emit
from .table1_torch import make_trainer, mnist_like_fed


def run(rounds: int = 80, device=None) -> dict:
    """Each ablation's final accuracy (Walkman, one client a round, runs
    5× the rounds) and the literal Eq. 11's first movement."""
    device = resolve_device(device)
    data, shape = mnist_like_fed(n_clients=10, n_samples=1500, device=device)
    model = get_model("mlr", shape)

    runs = {
        "prox_sgd(default)": make_trainer("rwsadmm", model, data,
                                          device=device),
        "closed_form(eq10)": make_trainer("rwsadmm_cf", model, data,
                                          device=device),
        "walkman(consensus)": make_trainer("walkman", model, data,
                                           device=device),
        "metropolis": RWSADMMTrainer(
            model, data, RWSADMMHparams(beta=1.0, kappa=0.001,
                                        epsilon=1e-5),
            zone_size=8, batch_size=32, transition="metropolis",
            device=device),
    }
    out = {}
    for name, tr in runs.items():
        r = rounds if "walkman" not in name else rounds * 5
        res = run_simulation(tr, rounds=r, eval_every=r, seed=0)
        out[name] = {"acc": res.final["acc"], "rounds": r,
                     "comm_mb": res.total_comm_bytes / 1e6}
        emit(f"ablation/{name}", res.wall_time_s / r * 1e6,
             f"acc={res.final['acc']:.4f}")

    # The literal Eq. (11) from Eq. 32's initialization (x = y, z = 0):
    # sgn(y − x) = 0, so x never moves. y and g from a numpy seed.
    rng = np.random.default_rng(0)
    y, g = (torch.as_tensor(rng.standard_normal(64), dtype=torch.float32,
                            device=device) for _ in range(2))
    x_lit = rwsadmm.x_update(y, y, torch.zeros_like(y), g,
                             RWSADMMHparams(beta=10.0), literal_eq11=True)
    moved = float((x_lit - y).abs().max())
    emit("ablation/literal_eq11_first_step", 0.0,
         f"max_movement={moved} (0.0 == paper formula is inert at init)")
    if moved != 0.0:
        raise AssertionError(f"literal Eq. 11 moved {moved} from the init")
    out["literal_eq11_first_step"] = moved
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=80)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    run(args.rounds, args.device)
