"""The dry-run's record and its readers: ``roofline_row`` under the
reference's TPU v5e constants gives ``benchmarks/roofline_report.py``'s
terms on an equivalent record, and the H100's constants by default;
``LiveBytes`` reads the exact peak of a toy meta step (views, in-place
ops, frees and autograd's saved tensors); one matmul's bytes accessed are
its three operands'; a tinyllama-1.1b decode_32k record carries every new
field; ``fill_experiments`` is idempotent and says what is missing;
``perf_iterations`` writes its record."""
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmarks import roofline_report as ref_roofline
from repro_torch.launch import (fill_experiments, perf_iterations,
                                 roofline_report)
from repro_torch.launch.dryrun import LiveBytes, RankCounter
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5E = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
RECORD = "tinyllama-1.1b__decode_32k__pod1.json"


def _run(*args, cwd=ROOT, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    return res.stdout


@pytest.fixture(scope="module")
def dry_dir(tmp_path_factory):
    """One real record, from the dry-run's own process (its fake group)."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    _run("repro_torch.launch.dryrun", "--arch", "tinyllama-1.1b",
         "--shape", "decode_32k", "--out", str(out))
    return out


# ------------------------------------------------------------ roofline --
def _records(kind: str, multi_pod: bool):
    """A port record and the reference's equivalent: its flops a chip and
    its collectives' full buffers."""
    chips = 512 if multi_pod else 256
    per_rank = 3.25e13
    coll = {"all-gather": {"count": 7, "bytes": 6.4e9, "bytes_in": 4e8},
            "reduce-scatter": {"count": 3, "bytes": 2e8, "bytes_in": 3.2e9},
            "all-reduce": {"count": 5, "bytes": 1.5e9, "bytes_in": 1.5e9},
            "all-to-all": {"count": 1, "bytes": 7e7, "bytes_in": 7e7}}
    common = {"arch": "qwen2-7b", "shape": f"{kind}_x", "kind": kind,
              "n_chips": chips, "multi_pod": multi_pod, "seq_len": 4096,
              "global_batch": 256, "active_params": 7_615_616_512}
    port = dict(common, flops=per_rank * chips * 1.7,
                flops_per_rank=per_rank, bytes_accessed_per_rank=8.5e11,
                collectives=coll, dtype="bfloat16",
                mesh=({"pod": 2, "data": 16, "model": 16} if multi_pod
                      else {"data": 16, "model": 16}))
    ref = dict(common, flops=per_rank * 1.7, bytes_accessed=8.5e11,
               collectives={k: max(v["bytes"], v["bytes_in"])
                            for k, v in coll.items()})
    return port, ref


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_roofline_row_matches_the_reference_under_its_constants(
        kind, multi_pod):
    port, ref = _records(kind, multi_pod)
    port["flops_per_rank"] = ref["flops"]
    got = roofline_report.roofline_row(port, **V5E)
    want = ref_roofline.roofline_row(ref)
    for k in ("t_compute_s", "t_memory_s", "t_collective_s", "model_flops",
              "hlo_flops_total", "useful_ratio", "coll_bytes",
              "step_time_s"):
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k
    for k in ("dominant", "mesh", "chips", "arch", "shape"):
        assert got[k] == want[k], k
    assert roofline_report.suggestion(got) == ref_roofline.suggestion(want)


def test_roofline_row_takes_the_h100_by_default():
    port, _ = _records("train", False)
    row = roofline_report.roofline_row(port)
    assert row["peak_flops"] == 989e12 and row["hbm_bw"] == 3.35e12
    assert row["link_bw"] == 50e9                # 256 ranks span nodes
    assert row["t_compute_s"] == port["flops_per_rank"] / 989e12
    assert row["t_compute_even_s"] == port["flops"] / 256 / 989e12
    assert row["t_memory_s"] == 8.5e11 / 3.35e12
    # the reduce-scatter's full buffer is its input, the gather's output
    assert row["coll_bytes"] == 6.4e9 + 3.2e9 + 2 * 1.5e9 + 7e7
    small = dict(port, n_chips=8, dtype="float32")
    row = roofline_report.roofline_row(small)
    assert row["link_bw"] == 450e9 and row["peak_flops"] == 67e12


# ------------------------------------------------------ the dry-run's --
def test_live_bytes_reads_the_exact_peak_of_a_meta_step():
    a = torch.empty(1000, device="meta")          # an argument: not counted
    with LiveBytes() as live:
        b = a * 2                                  # 4,000
        c = b + 1                                  # 8,000
        v = c.view(10, 100)                        # a view: nothing new
        a.add_(1)                                  # in place: nothing new
        del b                                      # 4,000
        d = c * c                                  # 8,000
        e = torch.cat([d, d])                      # 16,000: the peak
        del d, e                                   # 4,000
        f = c[:10].clone()                         # 4,040
    assert (live.peak, live.current, live.created) == (16_000, 4_040, 5)
    del c, v, f
    assert live.current == 0


def test_live_bytes_counts_what_autograd_saves():
    x = torch.empty(256, device="meta", requires_grad=True)
    with LiveBytes() as live:
        y = x * 3.0                                # 1,024
        z = y * y                                  # 2,048; saves y twice
        del y
        assert live.current == 2_048               # y lives on for backward
        del z                                      # the graph goes with it
    assert (live.peak, live.current) == (2_048, 0)


def test_bytes_accessed_of_one_matmul():
    m, k, n = 64, 32, 16
    a = torch.empty(m, k, device="meta")
    b = torch.empty(k, n, device="meta")
    with RankCounter() as counter:
        out = a @ b
        out.t()                                    # a view moves nothing
    assert counter.bytes_accessed == (m * k + k * n + m * n) * 4
    assert counter.flops == 2 * m * k * n
    assert counter.live.peak == m * n * 4


def test_tinyllama_decode_record_carries_the_new_fields(dry_dir):
    rec = json.loads((dry_dir / RECORD).read_text())
    assert rec["status"] == "ok" and rec["dtype"] == "bfloat16"
    for key in ("temp_bytes_per_rank", "peak_bytes_per_rank",
                "bytes_accessed_per_rank"):
        assert rec[key] is not None and rec[key] > 0, key
    assert rec["peak_bytes_per_rank"] == (
        rec["argument_bytes_per_rank"]["total"] + rec["temp_bytes_per_rank"])
    assert rec["bytes_accessed_per_rank"] > rec["peak_bytes_per_rank"] / 4
    for kind, entry in rec["collectives"].items():
        assert entry["bytes_in"] > 0 and entry["count"] > 0, kind
    rs = rec["collectives"]["reduce-scatter"]
    assert rs["bytes_in"] > rs["bytes"]            # the input is the buffer


# --------------------------------------------------------- the readers --
def test_roofline_run_writes_its_table(dry_dir, tmp_path):
    out = tmp_path / "roofline.md"
    rows = roofline_report.run(str(dry_dir), str(out))
    assert [r["arch"] for r in rows] == ["tinyllama-1.1b"]
    assert "| tinyllama-1.1b | decode_32k | 16x16 |" in out.read_text()


def test_fill_experiments_is_idempotent(dry_dir, tmp_path, capsys):
    md = tmp_path / "EXPERIMENTS.md"
    md.write_text("intro\n<!-- DRYRUN_TABLE -->\nold rows\n"
                  "<!-- /DRYRUN_TABLE -->\nmiddle\n<!-- ROOFLINE_TABLE -->\n"
                  "tail\n")
    assert fill_experiments.run(str(md), str(dry_dir))
    once = md.read_text()
    assert fill_experiments.run(str(md), str(dry_dir))
    assert md.read_text() == once
    assert "old rows" not in once and once.count("tinyllama-1.1b |") == 2
    assert once.startswith("intro\n") and "<!-- /ROOFLINE_TABLE -->" in once
    # missing markers, file or records: tables printed, nothing written
    bare = tmp_path / "bare.md"
    bare.write_text("no markers\n")
    assert not fill_experiments.run(str(bare), str(dry_dir))
    assert bare.read_text() == "no markers\n"
    assert not fill_experiments.run(str(tmp_path / "none.md"),
                                    str(tmp_path / "empty"))
    said = capsys.readouterr().out
    assert "no <!-- DRYRUN_TABLE --> in" in said
    assert "no file" in said and "no ok dry-run records" in said


def test_perf_iterations_writes_its_record(tmp_path):
    out = tmp_path / "perf"
    said = _run("repro_torch.launch.perf_iterations", "--pair",
                "tinyllama-1.1b:decode_32k", "--option", "embed_mode=tp_d",
                "--out", str(out), cwd=str(tmp_path))
    rec = json.loads((out / "tinyllama-1.1b__decode_32k__embed_mode-tp_d"
                      ".json").read_text())
    assert rec["options"] == {"embed_mode": "tp_d"}
    for arm in ("baseline", "optimized"):
        assert set(rec[arm]["terms"]) == set(perf_iterations.TERMS)
        assert rec[arm]["temp_bytes_per_rank"] > 0
    assert rec["speedup"] > 0 and "roofline step-time speedup" in said
