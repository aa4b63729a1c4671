"""One dry-run variant against its baseline, as roofline terms (the JAX
package's ``benchmarks/perf_iterations.py``).

  PYTHONPATH=src python -m repro_torch.launch.perf_iterations \\
      --pair tinyllama-1.1b:train_4k --option ce_impl=onehot

Runs the pair's baseline (``dryrun.DEFAULT_OPTIONS``) and the variant
(each ``--option k=v`` over them) on a fake group of 256 ranks (512 with
``--multi-pod``; the counterpart of the reference's
``ensure_host_platform_devices(512)``), prints both sets of terms
(``roofline_report.roofline_row``) and the roofline step-time speedup,
and writes ``results/perf_torch/<arch>__<shape>__<tag>.json``. The fake
group is global to a process, so this runs in a process of its own.
"""
from __future__ import annotations

import argparse
import json
import os

import torch.distributed as dist

from . import dryrun
from .roofline_report import roofline_row

TERMS = ("t_compute_s", "t_compute_even_s", "t_memory_s", "t_collective_s",
         "dominant", "step_time_s")


def terms(rec: dict) -> dict:
    r = roofline_row(rec)
    return {k: r[k] for k in TERMS}


def parse_options(pairs) -> dict:
    """``["k=v", ...]`` as dry-run options: "True"/"False" become bools;
    a key that ``dryrun.DEFAULT_OPTIONS`` lacks raises."""
    options = {}
    for kv in pairs:
        k, _, v = kv.partition("=")
        if k not in dryrun.DEFAULT_OPTIONS:
            raise SystemExit(f"unknown option {k!r}; one of "
                             f"{sorted(dryrun.DEFAULT_OPTIONS)}")
        options[k] = v == "True" if v in ("True", "False") else v
    return options


def summary(rec: dict) -> dict:
    return {"collectives": rec["collectives"], "flops": rec["flops"],
            "flops_per_rank": rec["flops_per_rank"],
            "bytes": rec["bytes_accessed_per_rank"],
            "temp_bytes_per_rank": rec["temp_bytes_per_rank"],
            "seconds": rec["seconds"], "terms": terms(rec)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", required=True, help="arch:shape")
    ap.add_argument("--option", action="append", default=[],
                    help="k=v dry-run option (repeatable)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--out", default="results/perf_torch")
    args = ap.parse_args(argv)

    arch, _, shape = args.pair.partition(":")
    options = parse_options(args.option)
    os.makedirs(args.out, exist_ok=True)
    if not dist.is_initialized():
        dryrun.fake_group(512 if args.multi_pod else 256)
    dryrun.register_rules()

    out = {"arch": arch, "shape": shape, "multi_pod": args.multi_pod,
           "options": options}
    out["baseline"] = summary(dryrun.run_one(
        arch, shape, multi_pod=args.multi_pod))
    print("baseline:", json.dumps(out["baseline"]["terms"], indent=1))
    out["optimized"] = summary(dryrun.run_one(
        arch, shape, multi_pod=args.multi_pod, options=options))
    print("optimized:", json.dumps(out["optimized"]["terms"], indent=1))
    b = out["baseline"]["terms"]["step_time_s"]
    o = out["optimized"]["terms"]["step_time_s"]
    out["speedup"] = b / max(o, 1e-12)
    print(f"roofline step-time speedup: {out['speedup']:.2f}×")

    tag = args.tag or "_".join(f"{k}-{v}" for k, v in options.items()) \
        or "baseline"
    path = os.path.join(args.out, f"{arch}__{shape}__{tag}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
