"""The port's capture budget: one window key per engine and length (eager
adds none), a new length adds one, drift is reported both ways, an
injected recapture (a float in the key) fails, and the healthy smoke
sweep equals ``analysis/capture_budget_torch.json`` and the reference's
``chunk`` count in ``analysis/compile_budget.json``."""
import itertools
import json

import numpy as np

from repro_torch.analysis import capture_budget as cb
from repro_torch.analysis.check import BUDGET_PATH, REPO_ROOT, main
from repro_torch.analysis.registry import SMOKE, CellSpec, build_cell, drive
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_one_key_per_engine_and_length():
    trainer = build_cell(CellSpec("single", "dense", False))
    drive(trainer, "eager")
    assert trainer._chunk_shapes == set()          # eager captures nothing
    drive(trainer, "scan")
    drive(trainer, "scan")                         # same key: a replay
    assert len(trainer._chunk_shapes) == 1
    drive(trainer, "scan_fused")
    assert sorted(k[0] for k in trainer._chunk_shapes) == ["scan",
                                                           "scan_fused"]


def test_new_length_adds_one():
    trainer = build_cell(CellSpec("fleet", "dense", False))
    drive(trainer, "scan")
    state = trainer.init_state(0)
    sched = trainer.schedule(4, np.random.default_rng(2))
    trainer.run_chunk(state, sched, engine="scan")
    assert sorted(k[1] for k in trainer._chunk_shapes) == [3, 4]
    assert {k[2] for k in trainer._chunk_shapes} == {"roundrobin"}


def test_compare_budget_reports_both_directions():
    golden = {"chunk": 6}
    assert cb.compare_budget({"chunk": 6}, golden) == []
    up = cb.compare_budget({"chunk": 7}, golden)
    assert len(up) == 1 and "recapture" in up[0]
    down = cb.compare_budget({"chunk": 5}, golden)
    assert len(down) == 1 and "shrank" in down[0]
    new = cb.compare_budget({"chunk": 6, "round": 1}, golden)
    assert len(new) == 1 and new[0].startswith("round")


def test_compare_windows_reports_both_directions():
    golden = cb.expected_windows()
    assert cb.compare_windows(golden, golden) == []
    more = {k: dict(v) for k, v in golden.items()}
    more["single/dense/unsharded/scan"]["threefry_bits"] = 1
    less = dict(golden)
    less.pop("fleet/dense/unsharded/scan_fused")
    assert len(cb.compare_windows(more, golden)) == 1
    assert len(cb.compare_windows(less, golden)) == 1


def test_injected_recapture_fails_loudly():
    """A key that changes from window to window (a float in it) is the
    canonical silent recapture: the sentinel sees 2 captures where the
    healthy run sees 1."""
    trainer = build_cell(CellSpec("single", "dense", False))
    ticks = itertools.count()
    key = trainer._window_key
    trainer._window_key = lambda engine, rounds: key(engine, rounds) + (
        next(ticks) * 0.5,)
    drive(trainer, "scan")
    drive(trainer, "scan")
    measured = {"chunk": len(trainer._chunk_shapes)}
    assert measured == {"chunk": 2}
    problems = cb.compare_budget(measured, {"chunk": 1})
    assert len(problems) == 1 and "recapture" in problems[0]


def test_healthy_sweep_equals_golden_and_reference():
    golden = cb.load_golden(BUDGET_PATH)
    measured = cb.measure_budget()
    assert cb.compare_budget(measured, golden["captures"]) == []
    assert golden["windows"] == cb.expected_windows(SMOKE)
    ref = json.loads((REPO_ROOT / "analysis" / "compile_budget.json")
                     .read_text())["compilations"]
    assert measured == {"chunk": ref["chunk"]} == {"chunk": 6}
    raw = json.loads(BUDGET_PATH.read_text())
    assert raw["reference_compilations"] == ref
    assert main(["--skip-lint", "--skip-ruff", "--skip-audit",
                 "--json"]) == 0
