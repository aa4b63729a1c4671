"""The dry-run (``launch/dryrun.py``) on a fake process group, in
subprocesses (a process has one default group).

The reference's ``tests/test_dryrun_launch.py`` set, at its small input
shapes and debug meshes ((2, 4) ("data", "model"), multi-pod (2, 2, 2))
on an 8-rank fake group: tinyllama train (an all-reduce in the step) and
decode; multi-pod; recurrentgemma-9b and gemma3-12b at long_500k. The
port reads its collectives from the functional collectives DTensor
issues, so the reference's HLO parser has no counterpart to test.
Added: ``--all`` runs and skips exactly the reference's (arch × shape)
set; a dense train step's global ``flops`` on the mesh equals
``FlopCounterMode``'s count of the same step unsharded on meta; the
kernels' shape-only ops on DTensors. The MoE case (qwen3-moe train) and
kimi-k2-1t-a32b at full width are in ``test_torch_dryrun_moe.py``,
``DEFAULT_OPTIONS``' variants in ``test_torch_dryrun_options.py``.
"""
import ast
import json
import os
import subprocess
import sys

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = """
import json, sys
sys.path.insert(0, "src")
import torch
torch.set_num_threads(2)
import repro_torch.launch.dryrun as D
import repro_torch.launch.mesh as M
import repro_torch.configs.base as CB
"""

SMALL = PRELUDE + """
D.fake_group(8)
D.register_rules()
D.make_production_mesh = (
    lambda multi_pod=False: M._mesh((2, 2, 2), ("pod", "data", "model"))
    if multi_pod else M._mesh((2, 4), ("data", "model")))
CB.INPUT_SHAPES["train_4k"] = CB.InputShape("train_4k", 256, 8, "train")
CB.INPUT_SHAPES["prefill_32k"] = CB.InputShape("prefill_32k", 512, 8,
                                               "prefill")
CB.INPUT_SHAPES["decode_32k"] = CB.InputShape("decode_32k", 1024, 8,
                                              "decode")
CB.INPUT_SHAPES["long_500k"] = CB.InputShape("long_500k", 4096, 1, "decode")
out = {}
for arch, shape, mp, *opts in json.loads(sys.argv[1]):
    rec = D.run_one(arch, shape, multi_pod=mp,
                    options=opts[0] if opts else None)
    out["|".join([arch, shape, str(mp)] + [json.dumps(o) for o in opts])] = {
        k: rec[k] for k in ("flops", "flops_per_rank", "collectives",
                            "moe_collectives", "n_chips", "device_type",
                            "argument_bytes_per_rank",
                            "param_bytes_per_rank", "cuda_initialized",
                            "options", "plan")}
print("RESULT" + json.dumps(out))
"""


def _run(script, *args, timeout=400):
    proc = subprocess.run([sys.executable, "-c", script, *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=REPO, env=dict(os.environ, PYTHONPATH="src"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT")]
    return json.loads(line[0][len("RESULT"):])


def _small(combos):
    return _run(SMALL, json.dumps(combos))


def test_dense_train_and_decode_on_mesh():
    out = _small([["tinyllama-1.1b", "train_4k", False],
                  ["tinyllama-1.1b", "decode_32k", False]])
    tr = out["tinyllama-1.1b|train_4k|False"]
    assert tr["flops"] > 1e9 and 0 < tr["flops_per_rank"] < tr["flops"]
    assert tr["collectives"]["all-reduce"]["count"] > 0
    assert tr["n_chips"] == 8 and tr["device_type"] == "cpu"
    assert not tr["cuda_initialized"]
    assert tr["argument_bytes_per_rank"]["state"] > 2 * tr[
        "param_bytes_per_rank"]
    de = out["tinyllama-1.1b|decode_32k|False"]
    assert de["flops"] > 1e6
    assert set(de["argument_bytes_per_rank"]) == {"params", "batch",
                                                  "cache", "total"}


def test_multi_pod_mesh_shards_pod_axis():
    rec = _small([["tinyllama-1.1b", "train_4k", True]])[
        "tinyllama-1.1b|train_4k|True"]
    assert rec["flops"] > 0 and rec["n_chips"] == 8


def test_hybrid_long_context_decode():
    out = _small([["recurrentgemma-9b", "long_500k", True],
                  ["gemma3-12b", "long_500k", False]])
    for k, rec in out.items():
        assert rec["flops"] > 0, k


ALL = PRELUDE + """
import io, contextlib
D.fake_group(8)
ran = []
D.run_one = lambda arch, shape, multi_pod=False: (
    ran.append([arch, shape, multi_pod]) or {
        "flops": 0.0, "flops_per_rank": 0.0, "param_bytes_per_rank": 0,
        "collectives": {}, "seconds": 0.0})
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = D.main(["--all", "--out", sys.argv[1]])
skips = [l for l in buf.getvalue().splitlines() if l.startswith("SKIP")]
print("RESULT" + json.dumps({"rc": rc, "ran": ran, "skips": skips}))
"""


def test_all_runs_and_skips_the_references_set(tmp_path):
    from repro.configs import ALL_ARCHS, INPUT_SHAPES

    tree = ast.parse(open(os.path.join(
        REPO, "src/repro/launch/dryrun.py")).read())
    long_ok = next(ast.literal_eval(n.value) for n in tree.body
                   if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", "") == "LONG_OK")
    want = [[a, s, False] for a in ALL_ARCHS for s in INPUT_SHAPES
            if s != "long_500k" or a in long_ok]
    out = _run(ALL, str(tmp_path))
    assert out["rc"] == 0
    assert out["ran"] == want
    assert len(out["skips"]) == len(ALL_ARCHS) * len(INPUT_SHAPES) - len(
        want)


FLOPS = PRELUDE + """
import dataclasses
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.registry import batch_spec, build_model
D.fake_group(8)
D.make_production_mesh = lambda multi_pod=False: M._mesh(
    (2, 4), ("data", "model"))
CB.INPUT_SHAPES["train_4k"] = CB.InputShape("train_4k", 128, 8, "train")
cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2)
D.get_config = lambda arch: cfg
rec = D.run_one("tinyllama-1.1b", "train_4k")
model = build_model(cfg, device="meta")
hp = RWSADMMHparams(beta=10.0)
params = {k: v.detach() for k, v in model.named_parameters()}
step = make_train_step(model, hp)
state = init_train_state(params, hp)
with FlopCounterMode(display=False) as fc:
    step(state._replace(kappa=state.kappa.to("meta")),
         batch_spec(cfg, 8, 128))
print("RESULT" + json.dumps({"mesh": rec["flops"],
                             "single": fc.get_total_flops(),
                             "per_rank": rec["flops_per_rank"]}))
"""


def test_dense_global_flops_equal_the_unsharded_count():
    out = _run(FLOPS)
    assert out["mesh"] == out["single"] > 0
    assert out["per_rank"] < out["single"]


OPS = PRELUDE + """
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.rglru_scan.ops import rglru_scan
D.fake_group(4)
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
out = {}
a = distribute_tensor(torch.empty(8, 16, 32, device="meta"), mesh,
                      [Shard(0)])
h = rglru_scan(a, a)
out["scan"] = [str(h.placements[0]), list(h.shape), list(h.to_local().shape)]
q = distribute_tensor(torch.empty(4, 8, 16, dtype=torch.bfloat16,
                                  device="meta"), mesh, [Replicate()])
k = distribute_tensor(torch.empty(4, 64, 2, 16, dtype=torch.bfloat16,
                                  device="meta"), mesh, [Shard(1)])
n = distribute_tensor(torch.empty(4, dtype=torch.int32, device="meta"),
                      mesh, [Replicate()])
with CommDebugMode() as comm:
    o = flash_decode(q, k, k, n)
out["flash"] = [list(o.shape), str(o.dtype),
                sum(comm.get_comm_counts().values())]
print("RESULT" + json.dumps(out))
"""


def test_kernel_ops_on_dtensors():
    out = _run(OPS)
    # the scan keeps a batch split; decode gathers a cache split over S
    assert out["scan"] == ["S(0)", [8, 16, 32], [2, 16, 32]]
    assert out["flash"][:2] == [[4, 8, 16], "torch.bfloat16"]
    assert out["flash"][2] >= 1
