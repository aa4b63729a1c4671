"""The dry-run's options (``launch/dryrun.py``'s ``DEFAULT_OPTIONS``),
beside ``test_torch_dryrun.py``'s harness: each variant the port has
(the one-hot CE, pure-TP params, the d-split embedding, row-parallel
RG-LRU gates, Whisper's precomputed cross-attention K/V) driven through
``run_one`` on the (2, 4) debug mesh at the reference test's small
shapes, against the default run of the same (arch × shape).
"""
import json

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_dryrun import _small


def test_options_select_the_references_variants():
    # each of DEFAULT_OPTIONS' variants against the default run
    runs = {"tinyllama-1.1b|train_4k": [{"ce_impl": "onehot"},
                                        {"fsdp_params": False},
                                        {"embed_mode": "tp_d"}],
            "recurrentgemma-9b|decode_32k": [{"rglru_row_parallel": True}],
            "whisper-large-v3|decode_32k": [{"whisper_cross_kv": True}]}
    combos = []
    for key, variants in runs.items():
        arch, shape = key.split("|")
        combos += [[arch, shape, False, o] for o in [{}] + variants]
    out = _small(combos)

    def rec(key, opt):
        return out[f"{key}|False|{json.dumps(opt)}"]

    for key, variants in runs.items():
        base = rec(key, {})
        assert base["plan"] == "dtensor"
        for opt in variants:
            got = rec(key, opt)
            assert got["options"] == {**base["options"], **opt}
            assert got != base, (key, opt)
    tl = "tinyllama-1.1b|train_4k"
    # the one-hot CE works on the logits as split over the vocabulary
    assert (rec(tl, {"ce_impl": "onehot"})["flops_per_rank"]
            < rec(tl, {})["flops_per_rank"])
    # pure-TP params: no split over "data", more bytes a rank
    assert (rec(tl, {"fsdp_params": False})["param_bytes_per_rank"]
            > rec(tl, {})["param_bytes_per_rank"])
    # the lookup of a table split over d gathers nothing over the vocab
    assert (rec(tl, {"embed_mode": "tp_d"})["collectives"]
            != rec(tl, {})["collectives"])
    rg = "recurrentgemma-9b|decode_32k"
    assert (rec(rg, {"rglru_row_parallel": True})["collectives"]
            != rec(rg, {})["collectives"])
    # precomputed cross-attention K/V: a larger cache
    wh = "whisper-large-v3|decode_32k"
    assert (rec(wh, {"whisper_cross_kv": True})["argument_bytes_per_rank"]
            ["cache"] > rec(wh, {})["argument_bytes_per_rank"]["cache"])
