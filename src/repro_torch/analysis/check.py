"""``python -m repro_torch.analysis.check``: the port's invariant gate
(the JAX package's ``analysis/check.py``).

Runs the three analyzer layers (plus ruff, when installed) and exits
non-zero on any unbaselined problem:

1. **lint**: the AST rules (``repro_torch.analysis.rules``) over the
   port's Python surface (``DEFAULT_PATHS``); findings whose churn-stable
   fingerprints appear in ``analysis/baseline_torch.json`` are tolerated
   (it ships with none).
2. **audit**: the captured-window rules over every round and window call
   of the trainer × engine × plane × sharding matrix
   (``repro_torch.analysis.registry``), traced on the CPU.
3. **budget**: the captures of the fixed smoke sweep against
   ``analysis/capture_budget_torch.json``.

Flags: ``--json`` machine output; ``--skip-lint/--skip-ruff/
--skip-audit/--skip-budget`` to run a subset; ``--write-baseline`` /
``--write-budget`` regenerate the files; ``--paths`` overrides the linted
roots (files, directories or globs, relative to the repo root).
"""
from __future__ import annotations

import argparse
import glob
import json
import shutil
import subprocess
import sys
from pathlib import Path

from .lint import LintEngine

#: repo root = parents[3] of src/repro_torch/analysis/check.py
REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py", "chip_smoke.py",
                 "scripts", "benchmarks/*_torch.py", "examples/*_torch.py")
BASELINE_PATH = REPO_ROOT / "analysis" / "baseline_torch.json"
BUDGET_PATH = REPO_ROOT / "analysis" / "capture_budget_torch.json"


def expand(patterns) -> list[Path]:
    """Each root as files and directories under the repo root: a glob
    expands, a missing path drops out."""
    out: list[Path] = []
    for p in patterns:
        hits = sorted(glob.glob(str(REPO_ROOT / p)))
        out.extend(Path(h) for h in hits)
    return out


def _load_baseline(path: Path) -> set[str]:
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return {str(f["fingerprint"]) for f in data.get("findings", [])}


def run_lint(paths, baseline: set[str]):
    engine = LintEngine(root=REPO_ROOT)
    findings = engine.run(paths)
    new = [f for f in findings if f.fingerprint not in baseline]
    return new, len(findings) - len(new), engine


def run_ruff(paths) -> dict:
    """Optional layer 0: ruff with the repo's config, when installed; a
    host without it gets a visible skip, never a silent pass."""
    exe = shutil.which("ruff")
    if exe is None:
        return {"status": "skipped", "detail": "ruff not installed "
                "(pip install -r requirements-dev.txt)"}
    proc = subprocess.run([exe, "check", *[str(p) for p in paths]],
                          cwd=REPO_ROOT, capture_output=True, text=True)
    out = (proc.stdout + proc.stderr).strip()
    return {"status": "ok" if proc.returncode == 0 else "failed",
            "detail": out[-4000:]}


def run_audit():
    from .registry import audit_matrix

    reports = audit_matrix()
    return [f for r in reports for f in r.findings], reports


def run_budget(golden_path: Path = BUDGET_PATH):
    from .capture_budget import compare_budget, load_golden, measure_budget

    measured = measure_budget()
    if not golden_path.exists():
        return measured, [f"golden manifest missing: {golden_path} "
                          "(run --write-budget)"]
    return measured, compare_budget(measured,
                                    load_golden(golden_path)["captures"])


def write_baseline(engine: LintEngine, findings, paths) -> None:
    BASELINE_PATH.parent.mkdir(exist_ok=True)
    payload = {
        "comment": "Machine-readable clean-run artifact for "
                   "repro_torch.analysis. 'findings' fingerprints are "
                   "tolerated by the lint gate (grandfathered violations "
                   "— keep this empty); 'suppressions' inventories every "
                   "inline '# repro_torch: allow' so the baselined-"
                   "violation ledger lives in one place.",
        "findings": [f.to_dict() for f in findings],
        "suppressions": engine.suppression_inventory(paths),
    }
    BASELINE_PATH.write_text(json.dumps(payload, indent=2) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="the PyTorch port's invariant analyzer")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--baseline", type=Path, default=BASELINE_PATH)
    ap.add_argument("--paths", nargs="*", default=None,
                    help="roots to lint (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--skip-lint", action="store_true")
    ap.add_argument("--skip-ruff", action="store_true")
    ap.add_argument("--skip-audit", action="store_true")
    ap.add_argument("--skip-budget", action="store_true")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate analysis/baseline_torch.json from the "
                         "current lint run")
    ap.add_argument("--write-budget", action="store_true",
                    help="regenerate analysis/capture_budget_torch.json "
                         "from a fresh smoke sweep")
    args = ap.parse_args(argv)

    paths = expand(args.paths or DEFAULT_PATHS)
    report: dict = {}
    failed = False

    if not args.skip_lint:
        new, baselined, engine = run_lint(paths, _load_baseline(
            args.baseline))
        report["lint"] = {"new_findings": [f.to_dict() for f in new],
                          "baselined": baselined}
        if args.write_baseline:
            write_baseline(engine, new, paths)
            report["lint"]["baseline_written"] = str(BASELINE_PATH)
            new = []
        if new:
            failed = True

    if not args.skip_ruff:
        report["ruff"] = run_ruff(paths)
        if report["ruff"]["status"] == "failed":
            failed = True

    if not args.skip_audit:
        findings, reports = run_audit()
        report["audit"] = {
            "calls": len(reports),
            "findings": [f.to_dict() for f in findings],
            "summary": [{"name": r.name, "n_nodes": r.n_nodes,
                         "const_bytes": r.const_bytes,
                         "const_budget": r.const_budget} for r in reports],
        }
        if findings:
            failed = True

    if not args.skip_budget:
        from .capture_budget import write_golden

        measured, problems = run_budget()
        if args.write_budget:
            BUDGET_PATH.parent.mkdir(exist_ok=True)
            write_golden(BUDGET_PATH, measured)
            problems = []
            report.setdefault("budget", {})["golden_written"] = \
                str(BUDGET_PATH)
        report.setdefault("budget", {}).update(
            {"measured": measured, "problems": problems})
        if problems:
            failed = True

    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        _render_text(report)
    return 1 if failed else 0


def _render_text(report: dict) -> None:
    if "lint" in report:
        lint = report["lint"]
        for f in lint["new_findings"]:
            print(f"{f['path']}:{f['line']}:{f['col'] + 1}: "
                  f"[{f['rule']}] {f['message']}")
        tol = f" ({lint['baselined']} baselined)" if lint["baselined"] \
            else ""
        print(f"lint: {len(lint['new_findings'])} new finding(s){tol}")
    if "ruff" in report:
        r = report["ruff"]
        print(f"ruff: {r['status']}"
              + (f" — {r['detail']}" if r["status"] != "ok" else ""))
    if "audit" in report:
        a = report["audit"]
        for f in a["findings"]:
            print(f"{f['path']}: [{f['rule']}] {f['message']}")
        print(f"audit: {len(a['findings'])} finding(s) across "
              f"{a['calls']} calls")
    if "budget" in report:
        b = report["budget"]
        for p in b.get("problems", []):
            print(f"budget: {p}")
        print(f"budget: measured {b.get('measured')}"
              + (" [golden refreshed]" if "golden_written" in b else ""))


if __name__ == "__main__":
    sys.exit(main())
