"""Layer 3: the capture budget (the JAX package's ``compile_budget.py``).

The port compiles nothing at run time, but on a card it captures one
CUDA graph per window key, ``(engine, window length, fleet mode, whether
the window carries iw)`` (``RWSADMMTrainer._window_key``), and replays it
after that. A silent recapture (a key that changes from window to window,
say a float in it, or a trainer rebuilt per window) multiplies the
captures without failing any numeric test. The sentinel runs a fixed tiny
sweep (``registry.SMOKE`` × eager, scan, scan_fused) and compares the
captures it makes to a golden manifest (``analysis/capture_budget_torch.
json``). Any drift, up or down, fails.

* On the CPU (:func:`measure_budget`) a window is a loop and captures
  nothing, so the count is the distinct window keys each trainer ran
  (``_chunk_shapes``): the captures a card would make. Eager rounds run
  outside any window and capture nothing, where the reference compiles
  ``_round_impl`` twice and ``_rr_step_impl`` once; its ``chunk`` count is
  the same 6.
* On a card (:func:`measure_card`) the count is ``len(trainer.windows)``,
  and each window's ``captured`` kernel counts (the wrappers' launches
  during its capture: one ``threefry_draws`` a round, one zone update a
  ``scan_fused`` round) are held against the manifest's ``windows``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

from .registry import CHUNK_ROUNDS, SMOKE, CellSpec, build_cell, drive

ENGINES = ("eager", "scan", "scan_fused")
#: the kernel wrappers a window's capture counts
KERNELS = ("zone_update", "multizone_update", "threefry_bits",
           "threefry_draws")
#: what the reference's golden manifest holds for the same sweep
REFERENCE = {"_round_impl": 2, "_rr_step_impl": 1, "chunk": 6}


def expected_window(spec: CellSpec, engine: str,
                    rounds: int = CHUNK_ROUNDS) -> dict:
    """The kernel wrappers' calls in one window's capture: one draw launch
    a round; on ``scan_fused`` one zone update a round (the multi-zone
    kernel for the simultaneous fleet)."""
    out = dict.fromkeys(KERNELS, 0)
    out["threefry_draws"] = rounds
    if engine == "scan_fused":
        kind = ("multizone_update" if spec.trainer == "fleet_sim"
                else "zone_update")
        out[kind] = rounds
    return out


def expected_windows(cells: Sequence[CellSpec] = SMOKE) -> dict:
    return {f"{spec.key}/{engine}": expected_window(spec, engine)
            for spec in cells for engine in ENGINES if engine != "eager"}


def measure_budget(engines: Sequence[str] = ENGINES,
                   cells: Sequence[CellSpec] = SMOKE) -> dict[str, int]:
    """Run the sweep on the CPU with fresh trainers and count the window
    keys they ran: ``{"chunk": n}``."""
    total = 0
    for spec in cells:
        trainer = build_cell(spec)
        for engine in engines:
            drive(trainer, engine)
        total += len(trainer._chunk_shapes)
    return {"chunk": total}


def measure_card(device, engines: Sequence[str] = ENGINES,
                 cells: Sequence[CellSpec] = SMOKE) -> dict:
    """The sweep on a card, each window run twice (a capture, then a
    replay): ``{"captures": {"chunk": n}, "windows": {...}, "trainers":
    [...]}`` with each window's ``captured`` counts by cell and engine,
    and the trainers (for the caller's further checks)."""
    captures, windows, trainers = 0, {}, []
    for spec in cells:
        trainer = build_cell(spec, device)
        for engine in engines:
            for _ in range(1 if engine == "eager" else 2):
                drive(trainer, engine)
        captures += len(trainer.windows)
        for key, win in trainer.windows.items():
            windows[f"{spec.key}/{key[0]}"] = {
                k: int(win.captured.get(k, 0)) for k in KERNELS}
        trainers.append((spec, trainer))
    return {"captures": {"chunk": captures}, "windows": windows,
            "trainers": trainers}


def compare_budget(measured: dict[str, int], golden: dict[str, int]
                   ) -> list[str]:
    """Human-readable drift lines; empty means the budget holds."""
    problems = []
    for name in sorted(set(measured) | set(golden)):
        got, want = measured.get(name, 0), golden.get(name, 0)
        if got > want:
            problems.append(
                f"{name}: {got} captures (golden {want}) — recapture or "
                "window-key regression")
        elif got < want:
            problems.append(
                f"{name}: {got} captures (golden {want}) — sweep shrank; "
                "refresh analysis/capture_budget_torch.json")
    return problems


def compare_windows(measured: dict, golden: dict) -> list[str]:
    """Drift lines of the windows' captured kernel counts."""
    problems = []
    for key in sorted(set(measured) | set(golden)):
        got, want = measured.get(key), golden.get(key)
        if got != want:
            problems.append(f"window {key}: captured {got} (golden {want})")
    return problems


def load_golden(path: str | Path) -> dict:
    """The manifest: ``{"captures": {...}, "windows": {...}}``."""
    data = json.loads(Path(path).read_text())
    return {"captures": {str(k): int(v)
                         for k, v in data["captures"].items()},
            "windows": data["windows"]}


def write_golden(path: str | Path, measured: dict[str, int]) -> None:
    payload = {
        "comment": "Golden CUDA-graph capture counts for the fixed smoke "
                   "sweep (repro_torch.analysis.capture_budget): the "
                   "distinct window keys each trainer runs, one capture "
                   "each on a card, and the kernel wrappers' calls in each "
                   "window's capture. Eager rounds capture nothing. "
                   "Regenerate with python -m repro_torch.analysis.check "
                   "--write-budget.",
        "sweep": "registry.SMOKE x (eager, scan, scan_fused), 3-round "
                 "windows",
        "captures": dict(sorted(measured.items())),
        "reference_compilations": REFERENCE,
        "windows": expected_windows(),
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")
