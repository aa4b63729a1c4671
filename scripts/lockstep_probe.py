"""Where eager and ``scan_fused`` part on the main path's CNN, and why.

    python3 scripts/lockstep_probe.py [--steps 5]

Runs ``chip_smoke.compare_lockstep`` (eager's plain update and the fused
rounds through the update kernel, stepped together from one seed, cuDNN
deterministic) on the main path's configuration (the CIFAR CNN at full
width, n = 100, zone 8, batch 20, ``closed_form``, β = 100) for the
static single walker and K = 3 simultaneous fleet, and for the walks
cells of ``chip_smoke.WALK_RUNS`` that walk eager's stream. Each step
prints the gap one round adds from a common state (kernel against
plain y, before and after a biased walk's ``iw`` rescale) and how the
two trajectories part: their gaps going in (y, x', the gradients at
x'), the coordinates where sgn(y' − x') differs, and where x⁺ parts by
sign mismatch, gradient gap or neither. The static and biased cells
side by side show what the ``iw`` fold adds to the parting. A cell
whose gate fails is reported and the next one runs. Prints one JSON
line; needs a CUDA device and exits 2 without.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("lockstep_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import chip_smoke as smoke
    from repro_torch.fl.fleet_trainer import FleetRWSADMMTrainer
    from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer
    from repro_torch.fl.simulation import run_simulation

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.phase_build()
    device = torch.device("cuda")
    seed = smoke.MAIN["seed"]
    model, data, hp = smoke.build_main_path(device, seed)
    run_simulation(smoke.make_trainer(model, data, hp, device, seed + 1),
                   rounds=3, eval_every=3, seed=seed + 1,
                   engine="scan_fused")                  # warm-up
    cells = [("static", None, {}), ("static fleet3", "simultaneous", {})]
    cells += [(label, mode, kw) for label, mode, kw, _ in smoke.WALK_RUNS
              if not kw.get("batched_walk")]
    out = {}
    for label, mode, kw in cells:
        def make(mode=mode, kw=kw):
            common = dict(batch_size=smoke.MAIN["batch"],
                          zone_size=smoke.MAIN["zone"],
                          solver="closed_form", seed=seed, device=device,
                          **kw)
            if mode is None:
                return RWSADMMTrainer(model, data, hp, **common)
            return FleetRWSADMMTrainer(
                model, data, hp, n_walkers=smoke.FLEET["n_walkers"],
                sync_every=smoke.FLEET["sync_every"], fleet_mode=mode,
                **common)

        unit = "wall steps" if mode else "rounds"
        try:
            res = smoke.compare_lockstep(
                make, args.steps,
                lambda st: {k: v for k, v in smoke.state_leaves(st).items()
                            if k != "visited"}, unit, hp, label)
        except AssertionError as err:
            res = {"failed": str(err)}
        out[label] = res
        torch.cuda.empty_cache()
    print(json.dumps({"lockstep": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
