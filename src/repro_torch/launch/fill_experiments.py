"""The dry-run and roofline tables from the dry-run's records, spliced
into a markdown file (the JAX package's ``benchmarks/fill_experiments.py``).

  PYTHONPATH=src python -m repro_torch.launch.fill_experiments \\
      --md EXPERIMENTS.md [--dir results/dryrun_torch]

Each table replaces what stands between its markers,
``<!-- DRYRUN_TABLE -->`` … ``<!-- /DRYRUN_TABLE -->`` and
``<!-- ROOFLINE_TABLE -->`` … ``<!-- /ROOFLINE_TABLE -->`` (an opening
marker alone gets the closing one added), so running it again changes
nothing. Where the file, a marker or the records are missing it prints
the tables and says what is missing, and changes no file. The peak
column is ``peak_bytes_per_rank`` (arguments and temporaries), the
seconds column the dry-run's ``seconds``, the collectives each kind's
full buffer.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re

from ..configs import LONG_OK
from .roofline_report import full_buffer, roofline_row, suggestion

ARCH_ORDER = [
    "qwen2-7b", "xlstm-350m", "whisper-large-v3", "kimi-k2-1t-a32b",
    "tinyllama-1.1b", "recurrentgemma-9b", "gemma3-12b", "qwen2-vl-2b",
    "yi-34b", "qwen3-moe-30b-a3b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MARKERS = ("DRYRUN_TABLE", "ROOFLINE_TABLE")


def load_records(dry_dir: str = "results/dryrun_torch") -> dict:
    """Every ok record, by (arch, shape, multi_pod)."""
    recs = {}
    for path in sorted(glob.glob(os.path.join(dry_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        recs[(rec["arch"], rec["shape"], rec["multi_pod"])] = rec
    return recs


def _ordered(recs: dict):
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            for mp in (False, True):
                rec = recs.get((arch, shape, mp))
                if rec is not None:
                    yield arch, shape, rec


def dryrun_table(recs: dict) -> str:
    lines = [
        "| arch | shape | mesh | seconds | per-rank peak GB | "
        "per-rank GFLOPs | collective GB (full buffer, per kind) |",
        "|---|---|---|---|---|---|---|",
    ]
    for arch, shape, rec in _ordered(recs):
        coll = ", ".join(
            f"{k.replace('all-', 'a')}:{full_buffer(v) / 1e9:.2f}"
            for k, v in sorted(rec["collectives"].items())
            if k != "_counts" and full_buffer(v) > 0)
        peak = rec["peak_bytes_per_rank"] / 1e9
        lines.append(
            f"| {arch} | {shape} | {roofline_row(rec)['mesh']} "
            f"| {rec['seconds']:.1f} | {peak:.2f} "
            f"| {rec['flops_per_rank'] / 1e9:.1f} | {coll} |")
    skips = [a for a in ARCH_ORDER if a not in LONG_OK]
    lines.append("")
    lines.append(f"Skipped long_500k (full attention): {', '.join(skips)}.")
    return "\n".join(lines)


def roofline_table(recs: dict) -> str:
    lines = [
        "| arch | shape | mesh | compute s | even compute s | memory s | "
        "collective s | dominant | MODEL/flops | one-line next move |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch, shape, rec in _ordered(recs):
        r = roofline_row(rec)
        lines.append(
            f"| {arch} | {shape} | {r['mesh']} "
            f"| {r['t_compute_s']:.2e} | {r['t_compute_even_s']:.2e} "
            f"| {r['t_memory_s']:.2e} | {r['t_collective_s']:.2e} "
            f"| {r['dominant']} | {r['useful_ratio']:.2f} "
            f"| {suggestion(r)[:70]} |")
    return "\n".join(lines)


def splice(text: str, marker: str, content: str) -> str | None:
    """``text`` with ``content`` between ``marker``'s comments, or None
    where the opening marker is missing."""
    tag = f"<!-- {marker} -->"
    end_tag = f"<!-- /{marker} -->"
    if tag not in text:
        return None
    block = f"{tag}\n{content}\n{end_tag}"
    if end_tag in text:
        return re.sub(re.escape(tag) + r".*?" + re.escape(end_tag),
                      lambda _: block, text, count=1, flags=re.S)
    return text.replace(tag, block, 1)


def run(md_path: str, dry_dir: str = "results/dryrun_torch") -> bool:
    """Splice both tables into ``md_path``. Returns whether the file was
    written; where it was not, the tables are printed with the reason."""
    recs = load_records(dry_dir)
    tables = {"DRYRUN_TABLE": dryrun_table(recs),
              "ROOFLINE_TABLE": roofline_table(recs)}
    missing = []
    if not recs:
        missing.append(f"no ok dry-run records in {dry_dir}")
    text = None
    if not os.path.exists(md_path):
        missing.append(f"no file {md_path}")
    else:
        with open(md_path) as f:
            text = f.read()
        for marker, content in tables.items():
            new = splice(text, marker, content)
            if new is None:
                missing.append(f"no <!-- {marker} --> in {md_path}")
            else:
                text = new
    if missing:
        print("# fill_experiments: " + "; ".join(missing)
              + "; tables printed, no file changed")
        for marker, content in tables.items():
            print(f"\n## {marker}\n{content}")
        return False
    with open(md_path, "w") as f:
        f.write(text)
    print(f"{len(recs)} dry-run records spliced into {md_path}")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--md", default="EXPERIMENTS.md")
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    run(args.md, args.dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
