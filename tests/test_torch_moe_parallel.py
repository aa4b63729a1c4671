"""The MoE FFN's expert-parallel path (``models/moe.py``: ``moe_ffn``'s
shard arguments, ``moe_parallel``) against the JAX package's
``moe_ffn_local`` at the same shard arguments.

Shards: the reduced qwen3-moe and kimi configs have 4 experts (top-2,
kimi with one shared expert); shard i of n ∈ {2, 4} holds experts
[i·4/n, (i + 1)·4/n) and, as the reference's ``shard_map`` declares,
slice i of n of the shared expert's hidden dim. Both packages run with
no mesh (the reference's ``axis=None``) at ``test_torch_moe``'s
tolerances. The partials summed over the shards equal the unsharded
output within ``SUM_TOL`` (atol 1e-5, rtol 1e-5 in fp32): each token's
expert outputs are added in another order, so not bit for bit. Under 2
gloo ranks, ``axis`` sums the ranks' partials bit for bit as a local sum
of the same two partials does, and ``gather_axis`` gathers ZeRO-3
hidden slices back into the unsharded layer bit for bit; the gradients
of an ``LM`` expert parallel over (1, 2) and ZeRO-3 over (2, 1) equal
the meshless ``LM``'s within ``GRAD_TOL`` on every rank; a one-rank
(1, 1) mesh leaves an ``LM``'s logits and caches bit for bit equal to
the meshless ``LM``'s.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import moe as RM
from repro_torch.models import moe as PM
from test_torch_moe import ARCH, FFN_TOL, KIMI, _moe_pair, _x
from _torch_dist import run_ranks
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SUM_TOL = dict(atol=1e-5, rtol=1e-5)
#: the largest gradient difference from the meshless LM's, over the
#: largest gradient (fp32; the partials are summed in another order)
GRAD_TOL = 1e-5


def _ref_shard(params, i, n):
    """The reference's params of shard i of n (as ``shard_map`` slices
    them)."""
    def cut(w, axis):
        step = w.shape[axis] // n
        return np.take(w, np.arange(i * step, (i + 1) * step), axis=axis)

    out = {"router": params["router"], "w_in": cut(params["w_in"], 0),
           "w_gate": cut(params["w_gate"], 0),
           "w_out": cut(params["w_out"], 0)}
    if "shared" in params:
        sh = params["shared"]
        out["shared"] = {"w_in": cut(sh["w_in"], 1),
                         "w_gate": cut(sh["w_gate"], 1),
                         "w_out": cut(sh["w_out"], 0)}
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch,factor", [(ARCH, 4.0), (ARCH, 0.5),
                                         (KIMI, 4.0)])
def test_shards_match_reference_and_sum(arch, factor, n):
    rcfg, cfg, params, m = _moe_pair(arch, "float32", factor)
    x = _x((2, 24), cfg.d_model)
    xt = torch.as_tensor(x)
    with torch.no_grad():
        whole = PM.moe_ffn(m, xt, cfg)
        parts = []
        for i in range(n):
            want = np.asarray(RM.moe_ffn_local(
                _ref_shard(params, i, n), jax.numpy.asarray(x), rcfg,
                shard_index=i, n_shards=n))
            got = PM.moe_ffn(PM.shard_params(m, i, n), xt, cfg,
                             shard_index=i, n_shards=n)
            np.testing.assert_allclose(got.numpy(), want,
                                       **FFN_TOL["float32"])
            parts.append(got)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    np.testing.assert_allclose(total.numpy(), whole.numpy(), **SUM_TOL)


def test_shard_count_must_cover_the_experts():
    _, cfg, _, m = _moe_pair(ARCH, "float32", 4.0)
    with pytest.raises(ValueError, match="shards"):
        PM.moe_ffn(PM.shard_params(m, 0, 2), torch.zeros(1, 2, cfg.d_model),
                   cfg, shard_index=0, n_shards=4)


GLOO = """
import dataclasses
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.models import moe as PM
from repro_torch.models.transformer import LM, ShardingCtx
from repro_torch.launch.mesh import make_debug_mesh
init_group()
cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").reduced(),
                          n_layers=2)
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, capacity_factor=4.0))
torch.manual_seed(0)
m = PM.MoE(cfg, device="cpu")
with torch.no_grad():
    for p in m.parameters():
        p.copy_(torch.randn(p.shape) * 0.1)
x = torch.randn(2, 12, cfg.d_model)
out = {}


def grads(lm, tokens):
    named = dict(lm.named_parameters())
    with torch.enable_grad():
        loss = lm.loss({"tokens": tokens})
    return dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


with torch.no_grad():
    mine = PM.moe_ffn(PM.shard_params(m, RANK, WORLD), x, cfg,
                      axis=dist.group.WORLD, shard_index=RANK,
                      n_shards=WORLD)
    parts = [PM.moe_ffn(PM.shard_params(m, i, WORLD), x, cfg,
                        shard_index=i, n_shards=WORLD)
             for i in range(WORLD)]
    out["axis_sum_exact"] = bool(torch.equal(mine, parts[0] + parts[1]))
    whole = PM.moe_ffn(m, x, cfg)
    out["axis_sum_close"] = float((mine - whole).abs().max())
    zero3 = PM.moe_ffn(PM.shard_params(m, 0, 1, hidden_index=RANK,
                                       hidden_n=WORLD), x, cfg,
                       gather_axis=dist.group.WORLD)
    out["gather_exact"] = bool(torch.equal(zero3, whole))
    # an LM expert parallel over a (1, 2) mesh, and ZeRO-3 over (2, 1)
    model = LM(cfg, device="cpu").init(0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 10)))
    ref = model.apply({"tokens": tokens})
    for shape, zero3_moe in (((1, 2), False), ((2, 1), True)):
        ctx = ShardingCtx(mesh=make_debug_mesh(*shape), zero3_moe=zero3_moe)
        par = LM(cfg, ctx, device="meta")
        par.load_state_dict(model.state_dict(), assign=True)
        got = par.apply({"tokens": tokens})
        out[f"lm_{shape}"] = float((got - ref).abs().max())
    # the gradients of every parameter under each mesh: the ranks'
    # shares summed, every rank holding the meshless LM's
    ref_g = grads(model, tokens)
    scale = max(float(g.abs().max()) for g in ref_g.values())
    for shape, zero3_moe in (((1, 2), False), ((2, 1), True),
                             ((1, 2), True)):
        ctx = ShardingCtx(mesh=make_debug_mesh(*shape), zero3_moe=zero3_moe)
        par = LM(cfg, ctx, device="meta")
        par.load_state_dict(model.state_dict(), assign=True)
        got_g = grads(par, tokens)
        out[f"grad_{shape}_{zero3_moe}"] = max(
            float((got_g[k] - g).abs().max()) for k, g in ref_g.items()
        ) / scale
    out["grad_names"] = sorted(ref_g) == sorted(got_g)
emit(out)
"""


def test_axis_and_gather_axis_on_two_gloo_ranks(tmp_path):
    for out in run_ranks(GLOO, 2, tmp_path):
        assert out["axis_sum_exact"], out
        assert out["axis_sum_close"] < 1e-5, out
        assert out["gather_exact"], out
        assert out["lm_(1, 2)"] < 1e-4, out
        assert out["lm_(2, 1)"] == 0.0, out
        assert out["grad_names"], out
        for key in ("grad_(1, 2)_False", "grad_(2, 1)_True",
                    "grad_(1, 2)_True"):
            assert out[key] < GRAD_TOL, (key, out)


ONE = """
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import generate
from repro_torch.models.transformer import LM, ShardingCtx
init_group()
out = {}
for arch in ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"):
    cfg = get_config(arch).reduced()
    model = LM(cfg, device="cpu").init(0)
    par = LM(cfg, ShardingCtx(mesh=make_debug_mesh(1, 1), zero3_moe=True),
             device="meta")
    par.load_state_dict(model.state_dict(), assign=True)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16)))
    same = True
    with torch.no_grad():
        same &= torch.equal(model.apply({"tokens": tokens}),
                            par.apply({"tokens": tokens}))
    runs = [list(generate(m, {"tokens": tokens}, 6, 22))
            for m in (model, par)]
    for (t0, l0), (t1, l1) in zip(*runs):
        same &= torch.equal(t0, t1) and torch.equal(l0, l1)
    out[arch] = bool(same)
emit(out)
"""


def test_one_rank_mesh_lm_is_bitwise_meshless(tmp_path):
    (out,) = run_ranks(ONE, 1, tmp_path)
    assert out == {"qwen3-moe-30b-a3b": True, "kimi-k2-1t-a32b": True}
