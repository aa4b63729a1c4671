"""The dry-run's MoE cases (``launch/dryrun.py``), beside
``test_torch_dryrun.py``'s harness: qwen3-moe train on the (2, 4) debug
mesh at the reference test's small shapes, with the MoE layers'
reduction of the expert partials over "model" and the ZeRO-3 gathers of
the experts recorded; kimi-k2-1t-a32b train_4k at full width on the
(16, 16) fake mesh, its parameters' bytes a rank (the reference's rule
count, 9,037,041,664) and its train state's (x, z, y and κ), with the
process's peak RSS a few GiB (nothing allocated) and no CUDA context.
"""
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_dryrun import PRELUDE, _run, _small


def test_moe_expert_parallel_records_its_collectives():
    rec = _small([["qwen3-moe-30b-a3b", "train_4k", False]])[
        "qwen3-moe-30b-a3b|train_4k|False"]
    moe = rec["moe_collectives"]
    assert moe["all-reduce"]["count"] > 0      # partials over "model"
    # ZeRO-3: w_in, w_gate and w_out gathered in each of the 48 layers'
    # forward and again in its recompute, and nothing outside the layers
    assert moe["all-gather"]["count"] == 2 * 3 * 48
    assert rec["flops"] > rec["flops_per_rank"] > 0




KIMI = PRELUDE + """
D.fake_group(256)
D.register_rules()
rec = D.run_one("kimi-k2-1t-a32b", "train_4k")
print("RESULT" + json.dumps({k: rec[k] for k in (
    "param_bytes_per_rank", "argument_bytes_per_rank", "n_chips",
    "peak_rss_bytes", "cuda_initialized", "flops")}))
"""


def test_kimi_full_width_train_on_the_production_mesh():
    rec = _run(KIMI, timeout=600)
    assert rec["n_chips"] == 256
    assert rec["param_bytes_per_rank"] == 9_037_041_664
    # x, z and y: three copies of the params, and κ
    assert rec["argument_bytes_per_rank"]["state"] == 3 * 9_037_041_664 + 4
    assert rec["peak_rss_bytes"] < 6 * 2**30     # nothing allocated
    assert not rec["cuda_initialized"]
