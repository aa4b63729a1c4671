"""Roofline of the dry-run's records (the JAX package's
``benchmarks/roofline_report.py``) at the H100's constants.

Three terms per (arch × shape × mesh), each the time one rank would take:

  compute term    = flops_per_rank / peak FLOP/s for the record's dtype
  memory term     = bytes_accessed_per_rank / HBM bandwidth
  collective term = Σ_kind KIND_MULT[kind] × full buffer / link bandwidth

Beside the compute term, the even share ``flops / n_chips / peak``: the
rank's count is DTensor's plan, which replicates much that an even split
would divide (2.4–19.3 % of the global count where 1/256 would be even
at train_4k and prefill_32k), so a reader needs both. The memory term
reads the dry-run's unfused upper bound. A collective's full buffer is
the larger of what a rank hands in and what it receives (a
reduce-scatter's input, an all-gather's output), which the reference's
``KIND_MULT`` multiplies: a ring moves (n−1)/n ≈ 1× the full buffer over
its slowest link for an all-gather or a reduce-scatter, ≈ 2× for an
all-reduce.

Every constant is a keyword argument of :func:`roofline_row`; the
defaults are the H100 SXM's (card: NVIDIA H100 80GB HBM3, 700 W):

* HBM 3.35 TB/s, fp32 67 TFLOP/s (the port's kernel bounds, PERF.md §2);
* bf16 dense tensor cores 989 TFLOP/s (NVIDIA's H100 SXM datasheet);
* links: NVLink 450 GB/s each way within a node of 8; 400 Gb/s
  InfiniBand, 50 GB/s a GPU, across nodes. A 16 × 16 mesh spans 32 such
  nodes, so the collective term takes the slower link, as the reference
  takes its slowest.

Given the reference's TPU v5e constants (197e12, 819e9, 50e9) it gives
the reference's terms on an equivalent record.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline_report \\
      [--dir results/dryrun_torch] [--out results/dryrun_torch/roofline.md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

HBM_BW = 3.35e12             # bytes/s, H100 SXM HBM3 (PERF.md §2)
FP32_FLOPS = 67e12           # FLOP/s fp32, non-tensor (PERF.md §2)
BF16_FLOPS = 989e12          # FLOP/s bf16 dense tensor cores (datasheet)
NVLINK_BW = 450e9            # bytes/s each way, within a node
IB_BW = 50e9                 # bytes/s a GPU, 400 Gb/s InfiniBand
NODE_GPUS = 8                # GPUs a node (one NVLink domain)

KIND_MULT = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def full_buffer(entry) -> float:
    """A collective kind's full buffer: the larger of its inputs' and its
    results' bytes (a bare number is taken as it is)."""
    if isinstance(entry, dict):
        return float(max(entry.get("bytes", 0), entry.get("bytes_in", 0)))
    return float(entry)


def model_flops(rec: dict) -> float:
    """6·N·D for training, 2·N·D forward only (N the active parameters,
    D the tokens: a decode step's one token a sequence)."""
    n_params = rec["active_params"]
    if rec["kind"] == "train":
        return 6 * n_params * rec["seq_len"] * rec["global_batch"]
    if rec["kind"] == "prefill":
        return 2 * n_params * rec["seq_len"] * rec["global_batch"]
    return 2 * n_params * rec["global_batch"]


def mesh_label(rec: dict) -> str:
    mesh = rec.get("mesh")
    if isinstance(mesh, dict):
        return "x".join(str(v) for v in mesh.values())
    return "2x16x16" if rec.get("multi_pod") else "16x16"


def roofline_row(rec: dict, *, bf16_flops: float = BF16_FLOPS,
                 fp32_flops: float = FP32_FLOPS, hbm_bw: float = HBM_BW,
                 nvlink_bw: float = NVLINK_BW, ib_bw: float = IB_BW,
                 node_gpus: int = NODE_GPUS, peak_flops: float | None = None,
                 link_bw: float | None = None) -> dict:
    """The three terms of one ok record. The compute peak follows the
    record's dtype (bf16 and fp16 at ``bf16_flops``, else ``fp32_flops``)
    unless ``peak_flops`` is given; the link is NVLink within a node and
    InfiniBand beyond it unless ``link_bw`` is given."""
    chips = rec["n_chips"]
    if peak_flops is None:
        half = rec.get("dtype") in ("bfloat16", "float16")
        peak_flops = bf16_flops if half else fp32_flops
    if link_bw is None:
        link_bw = nvlink_bw if chips <= node_gpus else ib_bw
    coll = rec.get("collectives", {})
    coll_bytes = sum(KIND_MULT.get(k, 1.0) * full_buffer(v)
                     for k, v in coll.items() if k != "_counts")

    t_compute = rec["flops_per_rank"] / peak_flops
    t_compute_even = rec["flops"] / chips / peak_flops
    t_memory = rec.get("bytes_accessed_per_rank", 0.0) / hbm_bw
    t_coll = coll_bytes / link_bw
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    useful = model_flops(rec)
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "mesh": mesh_label(rec), "chips": chips,
        "dtype": rec.get("dtype"),
        "t_compute_s": t_compute, "t_compute_even_s": t_compute_even,
        "t_memory_s": t_memory, "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": useful,
        "hlo_flops_total": rec["flops"],
        "useful_ratio": useful / max(1.0, rec["flops"]),
        "coll_bytes": coll_bytes,
        "step_time_s": max(terms.values()),
        "peak_flops": peak_flops, "hbm_bw": hbm_bw, "link_bw": link_bw,
    }


SUGGESTIONS = {
    ("compute",): "increase per-chip arithmetic intensity is already the "
                  "bound — win by cutting redundant HLO flops (remat, "
                  "duplicate projections)",
    ("memory",): "fuse elementwise chains / cast activations to bf16 / "
                 "enlarge per-chip tile so HBM reads amortize",
    ("collective",): "reshard to cut the dominant collective (fewer "
                     "all-gathers via replicated decode weights, bigger "
                     "model-axis blocks, or overlap with compute)",
}


def suggestion(row: dict) -> str:
    return SUGGESTIONS[(row["dominant"],)]


def load(dry_dir: str = "results/dryrun_torch", **constants) -> list[dict]:
    """The roofline rows of every ok record in ``dry_dir``."""
    rows = []
    for path in sorted(glob.glob(os.path.join(dry_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") == "ok":
            rows.append(roofline_row(rec, **constants))
    return rows


def table(rows: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | compute s | even compute s | memory s "
        "| collective s | dominant | MODEL/flops | next move |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.3e} | {r['t_compute_even_s']:.3e} "
            f"| {r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} "
            f"| **{r['dominant']}** | {r['useful_ratio']:.2f} "
            f"| {suggestion(r)[:60]}… |")
    return "\n".join(lines) + "\n"


def run(dry_dir: str = "results/dryrun_torch",
        out_path: str = "results/dryrun_torch/roofline.md") -> list[dict]:
    """Write the roofline table of ``dry_dir``'s records to ``out_path``
    and print one line a row."""
    rows = load(dry_dir)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(table(rows))
    for r in rows:
        print(f"roofline/{r['arch']}/{r['shape']}/{r['mesh']},0.0,"
              f"dom={r['dominant']} step={r['step_time_s']:.3e}s "
              f"even_compute={r['t_compute_even_s']:.3e}s "
              f"useful={r['useful_ratio']:.2f}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--out", default="results/dryrun_torch/roofline.md")
    args = ap.parse_args(argv)
    rows = run(args.dir, args.out)
    print(f"{len(rows)} rows -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
