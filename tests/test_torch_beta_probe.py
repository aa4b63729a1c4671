"""Where the closed-form solver diverges on the CIFAR-shaped main path.

Runs single-walker RWSADMM (``closed_form``, ``engine="eager"``) on the
paper's CIFAR-10 CNN (c1 = 16, c2 = 32, fc = 512) over the repo's
``make_cifar_like`` stand-in, split with ``pathological_split``, in one
package per call, and prints one JSON line per (β, seed): the first round
whose training loss is not finite (null if none), and the losses.

    PYTHONPATH=src python tests/test_torch_beta_probe.py --package port
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_beta_probe.py \\
        --package reference

``port`` runs ``repro_torch`` on ``--device`` (default ``cuda``);
``reference`` runs the JAX package on its default backend. Both packages
start a seed from the same weights and draw the same minibatches and
dropout masks (the port's threefry is the reference's), so in fp32 they
follow one trajectory until the last bits of their gradients (XLA and
torch sum the convolutions in other orders) grow at max-pool near-ties;
from then on the two runs are samples of one distribution, as the
reference's own run is against itself started one ulp away
(``test_torch_cnn_baselines_probe.py --perturb``). The float64 run tier
(``test_torch_run_float64*.py``) holds the round itself seed for seed.
Defaults are the main path of ``chip_smoke.py`` (n = 100 clients, 12,000
samples, zone 8, batch 20); run it at that size on a machine with the
memory for it (x and z alone take 0.86 GB). Under pytest the probe runs
once per package at a tiny scale on the CPU, so the script keeps working.
"""
from __future__ import annotations

import argparse
import json
import math

import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def run_port(args, beta, seed):
    from repro_torch.core.rwsadmm import RWSADMMHparams
    from repro_torch.data import build_federated, pathological_split
    from repro_torch.data.synthetic_images import make_cifar_like
    from repro_torch.fl.base import to_device_data
    from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer
    from repro_torch.fl.simulation import run_simulation
    from repro_torch.models.small import CNN

    imgs, labels = make_cifar_like(args.samples, seed=seed)
    parts = pathological_split(labels, args.clients, seed=seed)
    data = to_device_data(build_federated(imgs, labels, parts), args.device)
    trainer = RWSADMMTrainer(CNN((32, 32, 3)), data,
                             RWSADMMHparams(beta=beta), batch_size=20,
                             zone_size=8, solver="closed_form", seed=seed,
                             device=args.device)
    return run_simulation(trainer, rounds=args.rounds,
                          eval_every=args.rounds, seed=seed, engine="eager")


def run_reference(args, beta, seed):
    from repro.core.rwsadmm import RWSADMMHparams
    from repro.data import pathological_split
    from repro.data.loader import build_federated
    from repro.data.synthetic_images import make_cifar_like
    from repro.fl.base import to_device_data
    from repro.fl.rwsadmm_trainer import RWSADMMTrainer
    from repro.fl.simulation import run_simulation
    from repro.models.small import make_cnn

    imgs, labels = make_cifar_like(args.samples, seed=seed)
    parts = pathological_split(labels, args.clients, seed=seed)
    data = to_device_data(build_federated(imgs, labels, parts))
    trainer = RWSADMMTrainer(make_cnn((32, 32, 3)), data,
                             RWSADMMHparams(beta=beta), batch_size=20,
                             zone_size=8, solver="closed_form", seed=seed)
    return run_simulation(trainer, rounds=args.rounds,
                          eval_every=args.rounds, seed=seed, engine="eager")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("port", "reference"),
                    required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--betas", type=float, nargs="+", default=[10.0, 100.0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--samples", type=int, default=12_000)
    args = ap.parse_args(argv)
    run = run_port if args.package == "port" else run_reference
    for beta in args.betas:
        for seed in args.seeds:
            losses = [m["train_loss"] for m in run(args, beta, seed)
                      .round_metrics]
            first_nan = next((r for r, v in enumerate(losses)
                              if not math.isfinite(v)), None)
            print(json.dumps({"package": args.package, "beta": beta,
                              "seed": seed, "clients": args.clients,
                              "rounds": args.rounds,
                              "first_nonfinite_round": first_nan,
                              "losses": losses}), flush=True)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_probe_reports_each_run(package, capsys):
    main(["--package", package, "--device", "cpu", "--betas", "100",
          "--seeds", "0", "--rounds", "2", "--clients", "10",
          "--samples", "600"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert [(r["package"], r["beta"], r["seed"]) for r in rows] == \
        [(package, 100.0, 0)]
    assert len(rows[0]["losses"]) == 2
    assert all(math.isfinite(v) for v in rows[0]["losses"])
    assert rows[0]["first_nonfinite_round"] is None


if __name__ == "__main__":
    main()
