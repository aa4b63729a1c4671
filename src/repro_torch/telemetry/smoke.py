"""Tiny end-to-end telemetry smoke run (port of
``repro/telemetry/smoke.py``).

``python -m repro_torch.telemetry.smoke --out runs/ci-smoke`` builds a
small federated workload, runs a few RWSADMM rounds with telemetry on
(through the scan driver and a wireless scenario, so every event type —
round / visit / snapshot / phase / counter — is exercised), and prints
the run directory; ``python -m repro_torch.telemetry.report <dir>``
renders it. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

from .recorder import TelemetryRun


def smoke_run(run_dir: str, *, rounds: int = 6, eval_every: int = 3,
              n_clients: int = 8, engine: str = "scan",
              fleet: int = 0, seed: int = 0,
              profile: bool = False, device=None) -> TelemetryRun:
    """Run the smoke workload into ``run_dir`` and return the closed
    telemetry run. ``fleet=K`` (K > 0) drives the K-walker fleet
    trainer instead of the single walker."""
    from ..core.rwsadmm import RWSADMMHparams
    from ..data import build_federated, make_image_dataset, \
        pathological_split
    from ..fl.base import to_device_data
    from ..fl.fleet_trainer import FleetRWSADMMTrainer
    from ..fl.rwsadmm_trainer import RWSADMMTrainer
    from ..fl.simulation import run_simulation
    from ..models.small import get_model

    imgs, labels = make_image_dataset(40 * n_clients, seed=seed)
    parts = pathological_split(labels, n_clients, seed=seed)
    data = to_device_data(build_federated(imgs, labels, parts), device)
    model = get_model("mlr", (28, 28, 1))
    kw = dict(zone_size=4, batch_size=16, solver="closed_form",
              scenario="lossy_links", seed=seed, device=device)
    if fleet > 0:
        trainer = FleetRWSADMMTrainer(
            model, data, RWSADMMHparams(beta=10.0), n_walkers=fleet,
            sync_every=4, **kw)
    else:
        trainer = RWSADMMTrainer(model, data, RWSADMMHparams(beta=10.0),
                                 **kw)
    tel = TelemetryRun(run_dir, seed=seed, profile=profile,
                       config={"workload": "telemetry_smoke",
                               "fleet": fleet})
    with tel:
        run_simulation(trainer, rounds=rounds, eval_every=eval_every,
                       seed=seed, engine=engine, telemetry=tel,
                       verbose=True)
    return tel


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.smoke",
        description="Record a tiny telemetry run (CI smoke workload).")
    ap.add_argument("--out", default="runs/smoke", help="run directory")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--engine", default="scan",
                    choices=["eager", "scan", "scan_fused"])
    ap.add_argument("--fleet", type=int, default=0,
                    help="K > 0: run the K-walker fleet trainer")
    ap.add_argument("--profile", action="store_true",
                    help="also capture a torch.profiler trace")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    tel = smoke_run(args.out, rounds=args.rounds, engine=args.engine,
                    fleet=args.fleet, profile=args.profile,
                    device=args.device)
    print(tel.run_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
