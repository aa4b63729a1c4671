"""Device time of one round's draws (batch indices and keep masks) from
one tree.

    python3 scripts/draws_ab.py --src PATH/src --label parent

Imports ``repro_torch`` from ``--src`` (this repository's ``src`` by
default) and times the tree's own ``TrainerBase.zone_batch_indices`` on
the main path's configuration (the CIFAR CNN at full width, n = 100,
batch 20): a zone of 8 clients (the single walker) and the K = 3 fleet's
24, each from one round key. By ``torch.profiler`` device time per call
(``chip_smoke.device_time_ms``), cold (output sets kept alive until
their turn comes again, more than the 50 MB L2 in all) and warm (one
set), with the kernels a call runs; prints one JSON line. To compare two
trees, run it once per tree on one card in turns (parent, change, change,
parent); it needs a CUDA device and exits 2 without.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLD_BYTES = 64e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(HERE, "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("draws_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.src))
    import chip_smoke

    dev = torch.device("cuda")
    model, data, hp = chip_smoke.build_main_path(dev, 0)
    trainer = chip_smoke.make_trainer(model, data, hp, dev, 0)
    key = trainer.round_key(7)
    out = {"label": args.label, "device": torch.cuda.get_device_name(0),
           "card": chip_smoke.nvidia_smi_line()}
    for leaves in (8, 24):
        clients = torch.arange(leaves, device=dev) % data.n_clients
        idx, keep = trainer.zone_batch_indices(clients, key)
        nbytes = idx.numel() * 8 + sum(k.numel() for k in keep)
        sets = math.ceil(COLD_BYTES / nbytes)
        held = [None] * sets

        def call(i):
            def fn():
                held[i] = trainer.zone_batch_indices(clients, key)
            return fn
        cold = chip_smoke.device_time_ms([call(i) for i in range(sets)], 4)
        warm = chip_smoke.device_time_ms([call(0)], 50)
        out[f"{leaves} leaves"] = {
            "ms": cold["profiler"], "ms_warm": warm["profiler"],
            "graph_ms": cold["graph"], "graph_ms_warm": warm["graph"],
            "kernels_per_call": warm["kernels_per_call"],
            "by_kernel_warm": warm["by_kernel"], "bytes_out": nbytes,
            "cold_sets": sets}
        held.clear()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
