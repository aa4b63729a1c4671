"""The scaling twins (``benchmarks/scan_scaling_torch.py`` and
``benchmarks/fleet_scaling_torch.py``) on the CPU at n = 20 for 10
rounds: every engine runs, and its rows land in the rows file stamped
with the device. Rates on the CPU say nothing of the card's."""
import json

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
