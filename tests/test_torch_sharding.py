"""The port's sharding rules (``launch/sharding.py``) against the JAX
package's (``repro.launch.sharding``), rule for rule.

Specs are metadata, so both packages run on a stand-in mesh (an object
whose ``shape`` maps axis names to sizes, the reference tests' own
``FakeMesh``): (16, 16) ("data", "model"), (2, 16, 16) ("pod", "data",
"model") and (2, 4). The reference's params come from ``jax.eval_shape``
of its model's init at full width, the port's from its model on
``meta``; each port leaf (per layer) is held to the reference leaf it
stands for (stacked), the stacked leading None dropped. The reference
builds ``NamedSharding``s for batches and caches, which need a real jax
mesh; here its ``NamedSharding`` is patched to hand back the spec. A
subprocess on a fake 8-rank group checks that a dim over a tuple of axes
is split major axis first.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.launch.sharding as RS
from repro.configs import ALL_ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.models.registry import build_model as ref_build
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.launch import sharding as S
from repro_torch.models.registry import build_model
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}
#: (data_axes given, zero3_moe, embed_mode, rglru_row_parallel)
VARIANTS = [("dp", False, "model", False), (None, False, "model", False),
            ("dp", True, "model", False), ("dp", False, "tp_d", False),
            ("dp", False, "model", True)]
#: per-rank parameter bytes at (16, 16), data_axes ("data",), ZeRO-3 for
#: MoE (the dry-run's setting), by the reference's rules
RANK_BYTES = {"kimi-k2-1t-a32b": 9_037_041_664,
              "qwen3-moe-30b-a3b": 285_622_272,
              "yi-34b": 270_391_296, "tinyllama-1.1b": 8_777_728}


def _data_axes(mesh):
    return tuple(a for a in mesh.shape if a in ("pod", "data"))


_REF_LEAVES = {}


def _ref_leaves(arch):
    """The reference's params of ``arch`` at full width: path → leaf."""
    if arch not in _REF_LEAVES:
        model = ref_build(ref_config(arch))
        struct = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
        out = {}
        jax.tree_util.tree_map_with_path(
            lambda kp, leaf: out.__setitem__(
                "/".join(RS._key_str(k) for k in kp), leaf), struct)
        _REF_LEAVES[arch] = out
    return _REF_LEAVES[arch]


def test_archs_are_the_references():
    assert ALL_ARCHS == REF_ARCHS


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_spec_rule_for_rule(arch, mesh_name):
    mesh = FakeMesh(MESHES[mesh_name])
    cfg, rcfg = get_config(arch), ref_config(arch)
    ref = _ref_leaves(arch)
    model = build_model(cfg, device="meta")
    named = dict(model.named_parameters())
    assert {S.reference_path(n, cfg)[0] for n in named} == set(ref)
    for dp, zero3, embed, rowpar in VARIANTS:
        axes = _data_axes(mesh) if dp else None
        got = S.params_shardings(model, cfg, mesh, axes, zero3_moe=zero3,
                                 embed_mode=embed,
                                 rglru_row_parallel=rowpar)
        for name, p in named.items():
            path, stacked = S.reference_path(name, cfg)
            want = tuple(RS.param_spec(
                path, ref[path], rcfg, mesh, axes, zero3_moe=zero3,
                embed_mode=embed, rglru_row_parallel=rowpar))
            assert got[name] == (want[1:] if stacked else want), (
                name, dp, zero3, embed, rowpar)


@pytest.mark.parametrize("arch", sorted(RANK_BYTES))
def test_per_rank_parameter_bytes(arch):
    mesh = FakeMesh(MESHES["16x16"])
    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    specs = S.params_shardings(model, cfg, mesh, ("data",),
                               zero3_moe=cfg.moe is not None)
    total = sum(int(np.prod(S.local_shape(p.shape, specs[n], mesh)))
                * p.element_size() for n, p in model.named_parameters())
    assert total == RANK_BYTES[arch]


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's batch and cache rules handing back specs."""
    monkeypatch.setattr(RS, "NamedSharding", lambda mesh, spec: tuple(spec))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_shardings(mesh_name, ref_specs):
    mesh = FakeMesh(MESHES[mesh_name])
    dp = _data_axes(mesh)
    seen = set()
    for arch in ALL_ARCHS:
        cfg, rcfg = get_config(arch), ref_config(arch)
        seen.add(cfg.frontend)
        for kind in ("train", "prefill", "decode"):
            for batch in (None, 1, 256):
                want = RS.batch_shardings(rcfg, mesh, dp, kind, batch=batch)
                assert S.batch_shardings(cfg, mesh, dp, kind,
                                         batch=batch) == want
    assert {"vision_stub", "audio_stub"} <= seen


def _ref_kv(spec_tree):
    return spec_tree.k if hasattr(spec_tree, "k") else spec_tree


@pytest.mark.parametrize("batch,max_len", [(4, 64), (1, 128)])
@pytest.mark.parametrize("arch", [a for a in ALL_ARCHS
                                  if a != "whisper-large-v3"])
def test_cache_shardings(arch, batch, max_len, ref_specs):
    cfg, rcfg = get_config(arch), ref_config(arch)
    n_pat = len(cfg.layer_pattern)
    for mesh_name in ("16x16", "2x16x16"):
        mesh = FakeMesh(MESHES[mesh_name])
        dp = _data_axes(mesh)
        want = RS.cache_shardings(ref_build(rcfg), rcfg, mesh, dp, batch,
                                  max_len)
        got = S.cache_shardings(build_model(cfg, device="meta"), cfg, mesh,
                                dp, batch, max_len)
        assert got["step"] == want["step"] == ()
        for l, layer in enumerate(got["layers"]):
            ref = want["groups"][l % n_pat]
            for field in layer._fields:
                if field == "length":
                    continue
                assert getattr(layer, field) == getattr(ref, field)[1:], (
                    arch, l, field)


@pytest.mark.parametrize("project", [False, True])
def test_whisper_cache_shardings(project, ref_specs):
    arch = "whisper-large-v3"
    cfg, rcfg = get_config(arch), ref_config(arch)
    ref_model = ref_build(rcfg)
    for mesh_name, batch in (("16x16", 4), ("2x16x16", 1), ("2x4", 8)):
        mesh = FakeMesh(MESHES[mesh_name])
        dp = _data_axes(mesh)
        params = (jax.eval_shape(lambda: ref_model.init(
            jax.random.PRNGKey(0))) if project else None)
        want = RS.whisper_cache_shardings(ref_model, rcfg, mesh, dp, batch,
                                          64, params_struct=params)
        got = S.whisper_cache_shardings(build_model(cfg, device="meta"),
                                        cfg, mesh, dp, batch, 64,
                                        project=project)
        assert got["enc_out"] == want["enc_out"]
        for kv in got["self_kv"]:
            assert kv.k == want["self_kv"].k[1:]
            assert kv.v == want["self_kv"].v[1:]
        assert ("cross_kv" in got) == project == ("cross_kv" in want)
        if project:
            for k, v in got["cross_kv"]:
                assert k == want["cross_kv"]["k"][1:]
                assert v == want["cross_kv"]["v"][1:]


def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        mesh = torch.zeros(2, 16, 16)

    m = Mesh()
    spec = (("pod", "data"), "model")
    assert S.placements(spec, m) == [Shard(0), Shard(0), Shard(1)]
    assert S.placements((None, None), m) == [Replicate()] * 3
    assert S.local_shape((64, 32), spec, m) == (2, 2)
    with pytest.raises(ValueError, match="order"):
        S.placements((("data", "pod"), None), m)


MAJOR = r"""
import json, sys
sys.path.insert(0, "src")
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import sharding as S
out = []
for rank in range(8):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=8)
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    for spec in ((("pod", "data"), None), (("data", "model"), None)):
        shape, off = compute_local_shape_and_global_offset(
            (16, 3), mesh, S.placements(spec, mesh))
        out.append([rank, list(mesh.get_coordinate()), list(spec[0]),
                    list(shape), list(off)])
    dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


def test_tuple_axes_split_major_first():
    proc = subprocess.run([sys.executable, "-c", MAJOR], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT")]
    rows = json.loads(line[0][len("RESULT "):])
    names = ("pod", "data", "model")
    assert len(rows) == 16
    for rank, coord, axes, shape, off in rows:
        c = dict(zip(names, coord))
        # major axis first: block index = c[a0] · size(a1) + c[a1]
        block = c[axes[0]] * 2 + c[axes[1]]
        assert shape == [4, 3] and off == [4 * block, 0], (rank, axes)
