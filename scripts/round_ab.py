"""Steady ms per round of the RWSADMM engines from one tree.

    python3 scripts/round_ab.py --src PATH/src --label parent

Imports ``repro_torch`` from ``--src`` (this repository's ``src`` by
default) and times, with ``chip_smoke.time_steady_rounds`` from this
repository, the main path's configuration (the CIFAR CNN at full width,
n = 100, zone 8, batch 20, ``closed_form``, β = 100): ``eager``, ``scan``
and ``scan_fused`` rounds of the single walker and wall steps of the
K = 3 simultaneous fleet, median of 3 runs of 30, beside the device's
busy share in a profiled ``scan_fused`` window. Prints one JSON line. To
compare two trees, run it once per tree on one card in turns (parent,
change, change, parent); it needs a CUDA device and exits 2 without.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("eager_round_ms", "scan_round_ms", "scan_fused_round_ms",
        "eager_round_ms_runs", "scan_fused_round_ms_runs",
        "kernel_launches_per_round", "device_ms_per_round", "busy_share")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(HERE, "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("round_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.src))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    model, data, hp = chip_smoke.build_main_path(dev, 0)
    out = {"label": args.label, "device": torch.cuda.get_device_name(0),
           "card": chip_smoke.nvidia_smi_line()}
    for unit, make in (
            ("round", chip_smoke.make_trainer),
            ("wall step", chip_smoke.make_fleet)):
        steady = chip_smoke.time_steady_rounds(make(model, data, hp, dev, 0),
                                               unit)
        out[unit] = {k: steady[k] for k in KEYS}
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
