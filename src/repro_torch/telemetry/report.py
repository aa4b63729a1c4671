"""Run-report CLI: render a recorded telemetry run as a text summary
(port of ``repro/telemetry/report.py``).

``python -m repro_torch.telemetry.report runs/<id>`` reads ``manifest.json`` +
``events.jsonl`` and prints:

* ``== Run ==``                  manifest (algo, seed, device, git SHA)
* ``== Convergence ==``          eval snapshots + an ASCII accuracy curve
* ``== Coverage & staleness ==`` visit-trace coverage timeline and the
                                 staleness distribution trajectory
* ``== Communication ==``        byte / latency / energy totals
* ``== Phase times ==``          fenced phase-timer breakdown (compile-
                                 inclusive first calls split out)
* ``== Walkers ==``              per-walker fleet table (fleet runs)

The same renderer is importable (:func:`render_report`) so tests and CI
assert on the exact artifact users see. ``--json`` emits the summary as
machine-readable JSON instead.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

from .events import read_events, split_by_type

_BLOCKS = " ▁▂▃▄▅▆▇█"


def _spark(vals: list[float], width: int = 48) -> str:
    """ASCII sparkline, resampled to ``width`` columns."""
    if not vals:
        return ""
    if len(vals) > width:
        step = len(vals) / width
        vals = [vals[int(i * step)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(_BLOCKS[1 + int((v - lo) / span * (len(_BLOCKS) - 2))]
                   for v in vals)


def _fmt_row(cols, widths) -> str:
    return "  ".join(str(c).ljust(w) for c, w in zip(cols, widths)).rstrip()


def _table(header: list[str], rows: list[list]) -> list[str]:
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
              if rows else len(str(h)) for i, h in enumerate(header)]
    out = [_fmt_row(header, widths),
           _fmt_row(["-" * w for w in widths], widths)]
    out += [_fmt_row(r, widths) for r in rows]
    return out


def load_run(run_dir: str) -> tuple[dict, dict[str, list[dict]]]:
    """(manifest, events bucketed by type) for one run directory."""
    mpath = os.path.join(run_dir, "manifest.json")
    if not os.path.exists(mpath):
        raise FileNotFoundError(
            f"no manifest.json under {run_dir!r} — not a telemetry run")
    with open(mpath) as f:
        manifest = json.load(f)
    epath = os.path.join(run_dir, manifest.get("events", "events.jsonl"))
    buckets = split_by_type(read_events(epath)
                            if os.path.exists(epath) else [])
    return manifest, buckets


def summarize(run_dir: str) -> dict:
    """Machine-readable summary (what ``--json`` prints)."""
    manifest, b = load_run(run_dir)
    rounds = b["round"]
    visits = b["visit"]
    snaps = b["snapshot"]
    phases = b["phase"]

    comm = sum(int(r.get("comm_bytes", 0)) for r in rounds)
    latency = sum(float(r.get("latency_s", 0.0)) for r in rounds)
    energy = sum(float(r.get("energy_j", 0.0)) for r in rounds)

    seen: set[int] = set()
    coverage: list[tuple[int, int]] = []
    for v in visits:
        seen.add(v["client"])
        coverage.append((v["round"], len(seen)))

    phase_agg: dict[tuple, dict] = {}
    for p in phases:
        key = (p["name"], bool(p.get("includes_compile")))
        a = phase_agg.setdefault(key, {"calls": 0, "seconds": 0.0})
        a["calls"] += 1
        a["seconds"] += float(p["seconds"])
        if "device_seconds" in p:   # CUDA-event time of a fenced span
            a["device_seconds"] = (a.get("device_seconds", 0.0)
                                   + float(p["device_seconds"]))

    walkers: dict[int, dict] = defaultdict(
        lambda: {"visits": 0, "unique": set(), "zone": 0, "energy_j": 0.0})
    for v in visits:
        if "walker" in v:
            w = walkers[int(v["walker"])]
            w["visits"] += 1
            w["unique"].add(v["client"])
            w["zone"] += int(v.get("zone", 0))
            w["energy_j"] += float(v.get("energy_j", 0.0))

    return {
        "manifest": manifest,
        "n_rounds": len(rounds),
        "n_visits": len(visits),
        "snapshots": snaps,
        "final": snaps[-1] if snaps else {},
        "loss_curve": [float(r["train_loss"]) for r in rounds
                       if "train_loss" in r],
        "coverage": coverage,
        "unique_clients": len(seen),
        "staleness": [(r["round"], r["staleness_p50"], r["staleness_max"])
                      for r in rounds if "staleness_max" in r],
        "comm_bytes_total": comm,
        "latency_s_total": latency,
        "energy_j_total": energy,
        "phases": [
            {"name": k[0], "includes_compile": k[1], **a}
            for k, a in sorted(phase_agg.items())],
        "walkers": {
            k: {"visits": w["visits"], "unique_clients": len(w["unique"]),
                "mean_zone": (w["zone"] / w["visits"]) if w["visits"] else 0,
                "energy_j": w["energy_j"]}
            for k, w in sorted(walkers.items())},
        "counters": {c["name"]: c["value"] for c in b["counter"]},
    }


def render_report(run_dir: str) -> str:
    s = summarize(run_dir)
    m = s["manifest"]
    cfg = m.get("config", {})
    L: list[str] = []

    L.append("== Run ==")
    L.append(f"run_id:    {m.get('run_id')}   status: {m.get('status')}")
    L.append(f"algo:      {cfg.get('algo', '?')}   "
             f"engine: {cfg.get('engine', '?')}   "
             f"rounds: {s['n_rounds']}   seed: {m.get('seed')}")
    tx = m.get("torch") or {}
    devices = tx.get("devices") or ["?"]
    L.append(f"backend:   {tx.get('backend', '?')} "
             f"x{tx.get('device_count', '?')} ({devices[0]}, "
             f"{tx.get('power_limit')})   torch {tx.get('version', '?')} "
             f"cuda {tx.get('cuda')}   git {str(m.get('git_sha'))[:12]}")
    L.append(f"dir:       {os.path.abspath(run_dir)}")
    L.append("")

    L.append("== Convergence ==")
    snaps = s["snapshots"]
    if snaps:
        accs = [float(sn.get("acc", float("nan"))) for sn in snaps]
        L.append(f"acc  [{min(accs):.4f} … {max(accs):.4f}]  "
                 f"{_spark(accs)}")
        rows = [[sn.get("round"),
                 f"{float(sn.get('acc', float('nan'))):.4f}",
                 f"{float(sn.get('loss_personalized', sn.get('loss_global', float('nan')))):.4f}",
                 sn.get("comm_bytes_total", "")] for sn in snaps]
        L += _table(["round", "acc", "loss", "comm_bytes_total"], rows)
    elif s["loss_curve"]:
        lc = s["loss_curve"]
        L.append(f"train_loss  [{min(lc):.4f} … {max(lc):.4f}]  "
                 f"{_spark(lc)}")
    else:
        L.append("(no snapshots recorded)")
    L.append("")

    L.append("== Coverage & staleness ==")
    if s["coverage"]:
        frac = [c / max(s['unique_clients'], 1) for _, c in s["coverage"]]
        L.append(f"coverage    {s['unique_clients']} unique clients "
                 f"over {s['n_visits']} visits  {_spark(frac)}")
    else:
        L.append("(no visit trace recorded)")
    if s["staleness"]:
        p50 = [x[1] for x in s["staleness"]]
        mx = [x[2] for x in s["staleness"]]
        L.append(f"staleness_p50  last={p50[-1]:g}  max-seen="
                 f"{max(p50):g}  {_spark(p50)}")
        L.append(f"staleness_max  last={mx[-1]:g}  max-seen="
                 f"{max(mx):g}  {_spark([float(v) for v in mx])}")
    L.append("")

    L.append("== Communication ==")
    L.append(f"comm_bytes: {s['comm_bytes_total']:,}   "
             f"latency_s: {s['latency_s_total']:.6g}   "
             f"energy_j: {s['energy_j_total']:.6g}")
    L.append("")

    L.append("== Phase times ==")
    if s["phases"]:
        device = any("device_seconds" in p for p in s["phases"])
        rows = [[p["name"] + (" (incl. compile)" if p["includes_compile"]
                              else ""),
                 p["calls"], f"{p['seconds']:.4f}",
                 f"{p['seconds'] / p['calls'] * 1e3:.2f}"]
                + ([f"{p['device_seconds'] / p['calls'] * 1e3:.2f}"
                    if "device_seconds" in p else "-"] if device else [])
                for p in s["phases"]]
        L += _table(["phase", "calls", "total_s", "mean_ms"]
                    + (["device_mean_ms"] if device else []), rows)
    else:
        L.append("(no phase spans recorded)")
    L.append("")

    if s["walkers"]:
        L.append("== Walkers ==")
        rows = [[k, w["visits"], w["unique_clients"],
                 f"{w['mean_zone']:.2f}", f"{w['energy_j']:.4g}"]
                for k, w in s["walkers"].items()]
        L += _table(["walker", "visits", "unique_clients", "mean_zone",
                     "energy_j"], rows)
        L.append("")

    if s["counters"]:
        L.append("== Counters ==")
        L += [f"{k}: {v}" for k, v in sorted(s["counters"].items())]
        L.append("")
    return "\n".join(L)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report",
        description="Render a recorded telemetry run as a text summary.")
    ap.add_argument("run_dir", help="run directory (e.g. runs/<id>)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable summary instead")
    args = ap.parse_args(argv)
    if args.json:
        out = summarize(args.run_dir)
        json.dump(out, sys.stdout, indent=1, default=str)
        print()
    else:
        print(render_report(args.run_dir))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
