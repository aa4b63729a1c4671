"""Device time of the port's five kernels from one tree.

    python3 scripts/kernel_ab.py --src PATH/src --label parent
    python3 scripts/kernel_ab.py --keys-per-block 32 --label C32

Imports ``repro_torch`` from ``--src`` (this repository's ``src`` by
default), builds ``flash_decode`` and ``rglru_scan`` there, and times them
at the serving path's shapes with ``chip_smoke.device_time_ms`` from this
repository: ``flash_decode`` on (B, H, K, hd, S) = (4, 16, 1, 256, 2048)
bf16 over 10 input sets (84 MB, above the 50 MB L2: cold) and over one
(warm), ``rglru_scan`` on (4, 2040, 4096) fp32 over 2 sets and over one.
The three RWSADMM updates at the CNN's width (N = 1,068,266): the zone
round (Z = 8) and the fleet's (K = 3, Z = 8) over 2 sets, one client's
update over 6 (103 MB), each against one set, with their plain versions.
Both as the kernels' own device time per call (``torch.profiler``) and as
CUDA-graph replay time per call. Prints one JSON line. To compare two
trees, run it once per tree on one card in turns (parent, change,
change, parent); it needs a CUDA device and exits 2 without.
``--keys-per-block C`` builds ``flash_decode.cu`` with ``-DKEYS_PER_BLOCK=C``
(32, 64 or 128; the source's own is 64) to time another chunk size.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(HERE, "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--keys-per-block", type=int, choices=(32, 64, 128),
                    help="build flash decode with this C instead of the "
                    "source's")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.src))
    import chip_smoke
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.rglru_scan.ops import rglru_scan

    flash_decode = fd_ops.flash_decode
    if args.keys_per_block:
        fd_ops.NVCC_FLAGS += (f"-DKEYS_PER_BLOCK={args.keys_per_block}",)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, kv, hd, s = 4, 16, 1, 256, 2048
    length = torch.full((b,), s, dtype=torch.int32, device=dev)
    sets = [tuple(torch.randn(shape, generator=gen, device=dev)
                  .to(torch.bfloat16)
                  for shape in ((b, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
            for _ in range(10)]
    shape = (4, 2040, 4096)
    scans = [(torch.sigmoid(torch.randn(shape, generator=gen, device=dev)),
              torch.randn(shape, generator=gen, device=dev))
             for _ in range(2)]
    row = {"label": args.label, "src": args.src,
           "card": chip_smoke.nvidia_smi_line()}
    if args.keys_per_block:
        row["keys_per_block"] = fd_ops.keys_per_block()
    for name, fn, inputs, reps in (
            ("flash_decode", lambda q, k, v: flash_decode(q, k, v, length),
             sets, 20),
            ("rglru_scan", rglru_scan, scans, 10)):
        cold = chip_smoke.device_time_ms(
            [lambda t=t: fn(*t) for t in inputs], reps)
        warm = chip_smoke.device_time_ms([lambda: fn(*inputs[0])],
                                         reps * len(inputs))
        row[name] = {"ms_cold": cold["profiler"], "ms_warm": warm["profiler"],
                     "graph_ms_cold": cold["graph"],
                     "graph_ms_warm": warm["graph"],
                     "kernels_per_call": cold["kernels_per_call"],
                     "by_kernel_cold": cold["by_kernel"]}
    del sets, scans
    from repro_torch.core.rwsadmm import RWSADMMHparams

    hp = RWSADMMHparams(beta=100.0)
    kw = dict(beta=hp.beta, eps_half=hp.eps_half, n_total=100.0)
    for name, walkers, zone, live in (
            ("zone_update", 1, 8, (8,)),
            ("multizone_update", 3, 8, (8, 8, 8)),
            ("fused_update", 1, 1, (1,))):
        made = [chip_smoke.kernel_args(name, walkers, zone, chip_smoke.P_CNN,
                                       live, i, dev)
                for i in range(chip_smoke.COLD_SETS[name])]
        t = chip_smoke.time_update_kernel(name, made[0][1],
                                          [m[0] for m in made], kw)
        bound = chip_smoke.update_bound(name, zone, chip_smoke.P_CNN,
                                        made[0][2], row["card"])["bound_ms"]
        row[name] = {"ms_cold": t["ms"], "ms_warm": t["ms_warm"],
                     "graph_ms_cold": t["graph_ms"],
                     "graph_ms_warm": t["graph_ms_warm"],
                     "plain_ms_cold": t["plain_ms"],
                     "plain_ms_warm": t["plain_ms_warm"],
                     "bound_ms": bound, "share_cold": bound / t["ms"]}
        del made
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
