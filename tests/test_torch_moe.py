"""The port's Mixture-of-Experts FFN (``models/moe.py``) and its MoE archs
(``qwen3-moe-30b-a3b``, ``kimi-k2-1t-a32b``) against the JAX package's.

Both packages get the same numpy inputs. ``moe_ffn`` is held against
the reference's ``moe_ffn_local`` (no mesh) on the ``reduced()`` configs
(d = 256, 4 experts, top-2, expert width 128; kimi's with one shared
expert) at four points: no drop (capacity factor 4.0 = 2·E/k, so the
capacity is T), drops (factor 0.5: the capacity is a quarter of the
mean load), a shared expert, and the decode shape T = B at the
published factor 1.25. LM-level tests run the reduced LMs with the
reference's params carried over by ``convert.load_lm_reference``.

Tolerances:

- ``moe_ffn`` fp32: atol 1e-5, rtol 1e-5 (the same fp32 math, summed in
  other orders); bf16: the reference tests' atol 2e-2, rtol 3e-2. The
  routing (each token's top-k experts) must be equal; a flip is reported
  with its margin (the gap between the k-th and (k+1)-th probability).
- Gradients against ``jax.grad``: atol 1e-5, rtol 1e-4 (sums over the
  tokens; entries reach ~40 and the packages part by up to 1.5e-5, 4e-7
  of the largest).
- ``router_aux_loss``: 1e-6.
- LM logits and caches: ``test_torch_lm``'s TOL (atol 5e-5, rtol 1e-4);
  decode against a teacher-forced ``apply`` inside the port: the
  reference's own 2e-3 / 1e-3 (``tests/test_models_consistency.py``).
- RWSADMM steps: ``test_torch_train_step``'s STEP_TOL, with y's sign
  flips at ties left out and few.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core.rwsadmm import RWSADMMHparams as RHP
from repro.launch import steps as ref_steps
from repro.models import moe as RM
from repro.models.registry import build_model as ref_build
from repro.models.registry import random_batch as ref_batch
from repro_torch import convert
from repro_torch.configs import get_config, list_archs
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.launch import serve, steps
from repro_torch.models import moe as PM
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import LM
from test_torch_lm import TOL, _np, _ref_greedy, lm_state_to_reference
from test_torch_train_step import HP, MAX_FLIP_SHARE, N_TOTAL, STEP_TOL, \
    _as_port
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "qwen3-moe-30b-a3b"
KIMI = "kimi-k2-1t-a32b"
#: param_count() and active_param_count() of the full configs, the
#: reference's
COUNTS = {ARCH: (30_079_320_064, 2_900_230_144),
          KIMI: (1_043_854_307_328, 33_748_463_616)}
FFN_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
           "bfloat16": dict(atol=2e-2, rtol=3e-2)}
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
TEACHER_TOL = dict(atol=2e-3, rtol=1e-3)
#: (arch, capacity factor, x's (B, S)) of each moe_ffn case
CASES = {"no-drop": (ARCH, 4.0, (2, 24)), "drops": (ARCH, 0.5, (2, 24)),
         "shared": (KIMI, 4.0, (2, 24)), "decode": (ARCH, 1.25, (4, 1))}


def _configs(arch=ARCH, dtype="float32", factor=None):
    out = []
    for cfg in (ref_config(arch).reduced(), get_config(arch).reduced()):
        moe = cfg.moe if factor is None else dataclasses.replace(
            cfg.moe, capacity_factor=factor)
        out.append(dataclasses.replace(cfg, dtype=dtype, moe=moe))
    return out


def _moe_pair(arch, dtype, factor, seed=0):
    """Reference MoE params and config, and the port's ``MoE`` holding
    them."""
    rcfg, cfg = _configs(arch, dtype, factor)
    params = jax.tree_util.tree_map(
        np.asarray, RM.moe_init(jax.random.PRNGKey(seed), rcfg))
    m = PM.MoE(cfg, device="cpu")
    convert.load_reference(m, params)
    return rcfg, cfg, params, m


def _x(shape, d, seed=1):
    return np.random.default_rng(seed).normal(0, 1, (*shape, d)).astype(
        np.float32)


def _hold_routing(params, x, rcfg, m, cfg):
    """Each token's top-k experts equal in both packages, else the flipped
    tokens and their margins; returns the reference's experts (T, k)."""
    xf = np.array(x, np.float32).reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(jnp.asarray(xf) @ params["router"], axis=-1)
    _, want = jax.lax.top_k(probs, cfg.moe.top_k)
    want = np.asarray(want)
    with torch.no_grad():
        _, got = PM.route(m, torch.as_tensor(xf), cfg)
    flips = np.nonzero((got.numpy() != want).any(-1))[0]
    ranked = -np.sort(-np.asarray(probs), axis=-1)
    k = cfg.moe.top_k
    margins = ranked[flips, k - 1] - ranked[flips, k]
    assert not len(flips), f"routing flips at tokens {flips.tolist()}, " \
        f"margins {margins.tolist()}"
    return want


def _dropped_pairs(top_i, n_experts, cap):
    """The reference's rule in numpy: slots sorted stably by expert, a
    slot's position its rank in its expert's run, dropped at ≥ cap;
    returns the dropped (token, expert) pairs."""
    k = top_i.shape[1]
    flat = top_i.reshape(-1)
    order = np.argsort(flat, kind="stable")
    s_e = flat[order]
    pos = np.arange(flat.size) - np.searchsorted(s_e, np.arange(n_experts))[
        s_e]
    return {(int(o) // k, int(e)) for o, e, p in zip(order, s_e, pos)
            if p >= cap}


# ------------------------------------------------------------ moe_ffn --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_reference(case, dtype):
    """Output in the reference's dtype at FFN_TOL, the same routing, and
    the same (token, expert) slots dropped (some at factor 0.5, none
    elsewhere)."""
    arch, factor, shape = CASES[case]
    rcfg, cfg, params, m = _moe_pair(arch, dtype, factor)
    x = _x(shape, cfg.d_model)
    x_r = jnp.asarray(x, dtype=dtype)
    x_p = torch.as_tensor(x).to(getattr(torch, dtype))
    want = RM.moe_ffn_local(params, x_r, rcfg)
    with torch.no_grad():
        got = m(x_p)
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **FFN_TOL[dtype])
    top_i = _hold_routing(params, x_r.astype(jnp.float32), rcfg, m, cfg)
    t = int(np.prod(shape))
    cap = PM.capacity(t, cfg)
    assert cap == RM._capacity(t, rcfg)
    want_drop = _dropped_pairs(top_i, cfg.moe.n_experts, cap)
    with torch.no_grad():
        plan = PM.dispatch(*PM.route(m, x_p.reshape(t, -1), cfg),
                           cfg.moe.n_experts, cap)
    dropped = ~plan.valid
    got_drop = {(int(tok), int(e)) for tok, e in
                zip(plan.token[dropped], plan.expert[dropped])}
    assert got_drop == want_drop
    assert bool(want_drop) == (case == "drops")
    assert int(PM.dropped_slots(m, x_p, cfg)) == len(want_drop)


@pytest.mark.parametrize("case", ["no-drop", "drops", "shared"])
def test_moe_ffn_gradients_match_jax_grad(case):
    """d⟨moe_ffn(x), c⟩ with respect to x and every weight (router, the
    three expert tensors, the shared expert's) against ``jax.grad`` of
    the reference, dropped slots included, fp32."""
    arch, factor, shape = CASES[case]
    rcfg, cfg, params, m = _moe_pair(arch, "float32", factor)
    x = _x(shape, cfg.d_model)
    cot = _x(shape, cfg.d_model, seed=2)
    g_params, g_x = jax.grad(
        lambda p, x: jnp.sum(RM.moe_ffn_local(p, x, rcfg) * cot),
        argnums=(0, 1))(params, jnp.asarray(x))
    x_p = torch.as_tensor(x).requires_grad_()
    (m(x_p) * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(x_p.grad.numpy(), np.asarray(g_x),
                               **GRAD_TOL, err_msg="x")
    want = convert.state_from_reference(g_params)
    named = dict(m.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert float(p.grad.abs().max()) > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   **GRAD_TOL, err_msg=name)


def test_capacity_matches_reference():
    for arch in (ARCH, KIMI):
        for factor in (0.5, 1.0, 1.25, 4.0, 16.0):
            rcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=factor))
                for c in (ref_config(arch), get_config(arch)))
            for t in (1, 2, 3, 4, 5, 7, 16, 31, 100, 513, 2040, 2056, 8160,
                      8224, 1 << 16):
                assert PM.capacity(t, cfg) == RM._capacity(t, rcfg), \
                    (arch, factor, t)
    # the published factor: decode keeps every slot, prefill drops
    cfg = get_config(ARCH)
    assert PM.capacity(4, cfg) == 4
    assert PM.capacity(4 * 2040, cfg) == 638


@pytest.mark.parametrize("n_experts, top_k", [(4, 2), (128, 8)])
def test_router_aux_loss_matches_reference(n_experts, top_k):
    rcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, n_experts=n_experts, top_k=top_k)) for c in _configs())
    params = jax.tree_util.tree_map(
        np.asarray, RM.moe_init(jax.random.PRNGKey(3), rcfg))
    m = PM.MoE(cfg, device="cpu")
    convert.load_reference(m, params)
    x = _x((3, 40), cfg.d_model, seed=4)
    want = float(RM.router_aux_loss(params, jnp.asarray(x), rcfg))
    with torch.no_grad():
        got = float(PM.router_aux_loss(m, torch.as_tensor(x), cfg))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", [ARCH, KIMI])
def test_configs_and_counts_match_reference(arch):
    """Registered; ``param_count()`` and ``active_param_count()`` the
    reference's at full size; ``reduced()`` the reference's field by field
    (the port's fields); the built parameters the reference's, at full
    size on the meta device; a bf16 model keeps the router fp32."""
    assert arch in list_archs()
    full, rfull = get_config(arch), ref_config(arch)
    assert (full.param_count(), full.active_param_count()) == \
        (rfull.param_count(), rfull.active_param_count()) == COUNTS[arch]
    red, rred = get_config(arch).reduced(), ref_config(arch).reduced()
    for f in dataclasses.fields(red):
        want = getattr(rred, f.name)
        got = getattr(red, f.name)
        if f.name == "moe":
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert (red.param_count(), red.active_param_count()) == \
        (rred.param_count(), rred.active_param_count())
    for rcfg, cfg in ((rred, red), (rfull, full)):
        shapes = jax.eval_shape(ref_build(rcfg).init, jax.random.PRNGKey(0))
        want = {jax.tree_util.keystr(p): (x.shape, str(x.dtype))
                for p, x in jax.tree_util.tree_leaves_with_path(shapes)}
        port = LM(cfg, device="meta")
        assert sum(p.numel() for p in port.parameters()) == \
            sum(int(np.prod(s)) for s, _ in want.values())
        assert dict(port.layers[0].ffn.named_parameters()).keys() == {
            "router", "w_in", "w_gate", "w_out"} | (
            {"shared.w_in", "shared.w_gate", "shared.w_out"}
            if cfg.moe.n_shared_experts else set())
    port = LM(full, device="meta")
    dtypes = {n.split(".", 2)[-1]: p.dtype
              for n, p in port.named_parameters() if n.startswith("layers")}
    assert dtypes.pop("ffn.router") == torch.float32
    assert set(dtypes.values()) == {torch.bfloat16}
    assert tuple(port.layers[0].ffn.w_in.shape) == (
        full.moe.n_experts, full.d_model, full.moe.d_expert)


# -------------------------------------------------------------- LM --
def _pair(arch=ARCH, dtype="float32", seed=0):
    """Reference model and params, and the port's LM holding them."""
    rcfg, cfg = _configs(arch, dtype)
    ref = ref_build(rcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    ref.init(jax.random.PRNGKey(seed)))
    port = build_model(cfg, device="cpu")
    convert.load_lm_reference(port, params)
    return rcfg, cfg, ref, params, port


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("arch", [ARCH, KIMI])
def test_apply_logits_match_reference(arch):
    rcfg, cfg, ref, params, port = _pair(arch)
    tokens = ref_batch(rcfg, 2, 100, seed=3)["tokens"]
    want = ref.apply(params, {"tokens": tokens})
    with torch.no_grad():
        got = port.apply({"tokens": torch.as_tensor(np.asarray(tokens))})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("prompt", [7, 60])
def test_prefill_logits_and_caches_match_reference(pair, prompt):
    rcfg, cfg, ref, params, port = pair
    tokens = ref_batch(rcfg, 2, prompt, seed=4)["tokens"]
    logits_r, cache_r = ref.prefill(params, {"tokens": tokens}, 100)
    logits_p, cache_p = port.prefill(
        {"tokens": torch.as_tensor(np.asarray(tokens))}, 100)
    np.testing.assert_allclose(_np(logits_p), _np(logits_r), **TOL)
    assert cache_p["step"] == int(cache_r["step"]) == prompt
    for layer, got in enumerate(cache_p["layers"]):
        want = cache_r["groups"][0]
        assert got.length == prompt == int(want.length[layer])
        for field in ("k", "v"):
            np.testing.assert_allclose(_np(getattr(got, field)),
                                       _np(getattr(want, field))[layer],
                                       **TOL)


def test_greedy_decode_matches_reference(pair):
    """A 20-token prompt, then 24 greedy steps through ``serve.generate``
    (T = B = 2 tokens a step, capacity 4): ids equal, logits at TOL."""
    rcfg, cfg, ref, params, port = pair
    tokens = ref_batch(rcfg, 2, 20, seed=5)["tokens"]
    ids_r, logits_r = _ref_greedy(ref, params, tokens, 24, 44)
    ids_p, logits_p = zip(*serve.generate(
        port, {"tokens": torch.as_tensor(np.asarray(tokens))}, 24, 44))
    np.testing.assert_allclose(torch.stack(logits_p, 1).numpy(), logits_r,
                               **TOL)
    assert np.array_equal(torch.cat(ids_p, 1).numpy(), ids_r)


@pytest.mark.parametrize("prompt, total", [(7, 12), (20, 44)])
def test_decode_matches_teacher_forced_apply(pair, prompt, total):
    """Inside the port, as the reference's consistency test: prefill
    ``prompt`` tokens, feed the rest one at a time; each step's logits
    equal ``apply`` over all of them at that position. ``reduced()``'s
    capacity factor 2·E/k keeps every slot in both."""
    _, cfg, _, _, port = pair
    tokens = torch.as_tensor(np.asarray(
        ref_batch(pair[0], 2, total, seed=6)["tokens"]))
    with torch.no_grad():
        full = port.apply({"tokens": tokens})
        logits, cache = port.prefill({"tokens": tokens[:, :prompt]}, total)
        torch.testing.assert_close(logits, full[:, :prompt], **TEACHER_TOL)
        for t in range(prompt, total):
            lg, cache = port.decode_step(cache, tokens[:, t:t + 1])
            torch.testing.assert_close(lg, full[:, t], **TEACHER_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_params_round_trip(dtype):
    """Reference params → port LM → reference params, exactly, with kimi's
    nested ``ffn.shared`` leaves; the router stays fp32 in a bf16 model
    on both sides."""
    rcfg, cfg = _configs(KIMI, dtype)
    params = jax.tree_util.tree_map(
        np.asarray, ref_build(rcfg).init(jax.random.PRNGKey(1)))
    assert str(params["layers"][0]["ffn"]["router"].dtype) == "float32"
    state = convert.lm_state_from_reference(params, cfg)
    assert "layers.1.ffn.shared.w_gate" in state
    port = build_model(cfg, device="cpu")
    convert.load_lm_reference(port, params)
    for name, p in port.layers[1].ffn.named_parameters():
        want = torch.float32 if name == "router" else getattr(torch, dtype)
        assert p.dtype == state[f"layers.1.ffn.{name}"].dtype == want, name
    back = lm_state_to_reference(port.state_dict(), cfg)
    same = jax.tree_util.tree_map(
        lambda a, b: np.array_equal(a.astype(np.float32), b), params, back)
    assert jax.tree_util.tree_all(same)
    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["layers"][0]["ffn"]["shared"]["w_out"] = \
        bad["layers"][0]["ffn"]["shared"]["w_out"][:, :8]
    with pytest.raises(ValueError, match="shared.w_out"):
        convert.load_lm_reference(port, bad)


def test_train_steps_match_reference(pair):
    """Two RWSADMM steps of ``make_train_step`` on 2 × 24 tokens, each
    from the reference's state before it: loss and κ at STEP_TOL; x, z
    and y at STEP_TOL, with sign flips of y' − x at ties left out and
    few."""
    rcfg, cfg, ref, params, port = pair
    r_step = jax.jit(ref_steps.make_train_step(ref, RHP(**HP), N_TOTAL))
    step = steps.make_train_step(port, RWSADMMHparams(**HP), N_TOTAL)
    r_st = ref_steps.init_train_state(params, RHP(**HP))
    for t in range(2):
        tokens = ref_batch(rcfg, 2, 24, seed=20 + t)["tokens"]
        prev = {n: _as_port(getattr(r_st, n), cfg) for n in ("x", "z", "y")}
        st = steps.TrainState(**prev, kappa=torch.tensor(float(r_st.kappa)))
        r_next, r_loss = r_step(r_st, {"tokens": tokens})
        st, loss = step(st, {"tokens": torch.as_tensor(np.asarray(tokens))})
        np.testing.assert_allclose(float(loss), float(r_loss), **STEP_TOL)
        np.testing.assert_allclose(float(st.kappa), float(r_next.kappa),
                                   rtol=1e-7)
        want = {n: _as_port(getattr(r_next, n), cfg) for n in ("x", "z", "y")}
        flips = {}
        for leaf, y0 in prev["y"].items():
            gap = (y0 - want["x"][leaf]).abs() / (
                2 * (STEP_TOL["atol"] + STEP_TOL["rtol"] * y0.abs()))
            flip = torch.sign(y0 - want["x"][leaf]) != torch.sign(
                y0 - st.x[leaf])
            assert bool((gap[flip] <= 1).all()), (leaf, gap[flip])
            assert int(flip.sum()) <= MAX_FLIP_SHARE * flip.numel() + 1, leaf
            flips[leaf] = flip
        for name in ("x", "z", "y"):
            got = getattr(st, name)
            assert set(got) == set(want[name])
            for leaf, w in want[name].items():
                assert got[leaf].dtype == w.dtype, (name, leaf)
                keep = ~flips[leaf]
                np.testing.assert_allclose(
                    got[leaf][keep].numpy(), w[keep].numpy(), **STEP_TOL,
                    err_msg=f"step {t} {name} {leaf}")
        assert any(bool(v.abs().max() > 0)
                   for k, v in st.z.items() if ".ffn.w_" in k)
        r_st = r_next


def test_entry_points_need_a_gpu_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", ARCH, "--reduced", "--gen", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.load_model(ARCH, reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(_configs()[1])
