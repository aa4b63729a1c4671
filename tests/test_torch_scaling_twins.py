"""The scaling twins (``benchmarks/scan_scaling_torch.py`` and
``benchmarks/fleet_scaling_torch.py``) on the CPU at n = 20 for 10
rounds: every engine runs, and its rows land in the rows file stamped
with the device; the lazy-plane section and the telemetry overhead twin
at tiny sizes. Rates on the CPU say nothing of the card's."""
import json

import numpy as np
import pytest

from benchmarks import fleet_scaling_torch, scan_scaling_torch
from repro_torch.fl.rwsadmm_trainer import ENGINES
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _rows(path):
    with open(path) as f:
        return json.load(f)["rows"]


def test_scan_scaling_twin_on_cpu(tmp_path):
    out = tmp_path / "rows.json"
    res = scan_scaling_torch.run(10, (20,), "cpu", str(out))
    assert set(res[20]) == set(ENGINES)
    assert all(rps > 0 for rps in res[20].values())
    rows = _rows(out)
    assert [r["engine"] for r in rows] == list(ENGINES)
    assert {r["device"] for r in rows} == {"cpu"}
    assert all(r["power_limit"] is None and r["torch"] for r in rows)


@pytest.mark.parametrize("mode", ["roundrobin", "simultaneous"])
def test_fleet_scaling_twin_on_cpu(tmp_path, mode):
    out = tmp_path / "rows.json"
    res = fleet_scaling_torch.run(10, (20,), (1, 3), (mode,), "cpu",
                                  str(out))
    assert sorted(res) == [(mode, 20, k) for k in (1, 3)]
    assert len(_rows(out)) == 2 * len(ENGINES)
    hits = fleet_scaling_torch.hitting_times(20, (1, 3), 300, "cpu")
    assert hits[3] is not None and hits[3] <= hits[1]


def test_lazy_plane_twin_on_cpu(tmp_path):
    """``--lazy`` at n = 300, windows of 2 rounds: rows with the store's
    residency, counters and peaks, stamped; and ``--lazy-check``'s gates
    (prefetch on ≡ off, host columns the CPU schedule's) hold."""
    out = tmp_path / "rows.json"
    res = scan_scaling_torch.lazy_plane((300,), 2, capacity=64,
                                        device="cpu", out=str(out))
    assert sorted(res) == [300] and res[300] > 0
    rows = _rows(out)
    assert [r["name"] for r in rows] == ["scan_scaling/lazy_plane/n300/scan"]
    assert all(r["device"] == "cpu" and r["peak_device_mb"] is None
               and r["resident"] <= 64 and r["store_misses"] > 0
               for r in rows)
    check = scan_scaling_torch.lazy_check(300, rounds=2, device="cpu")
    assert all(check["checks"].values())


def test_telemetry_overhead_twin_on_cpu(tmp_path):
    from benchmarks import telemetry_overhead_torch

    out = tmp_path / "rows.json"
    res = telemetry_overhead_torch.measure(120, rounds=8, repeats=3,
                                           out=str(out))
    assert res["n"] == 120 and res["off_us"] > 0 and res["on_us"] > 0
    assert len(res["pair_pct"]) == 3
    assert res["overhead_pct"] == float(np.median(res["pair_pct"]))
    assert 0 < res["trace_pct"] < 100
    assert [r["name"] for r in _rows(out)] == [
        "telemetry_overhead/control_plane/n120/off",
        "telemetry_overhead/control_plane/n120/on"]
