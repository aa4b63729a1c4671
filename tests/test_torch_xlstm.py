"""The port's xLSTM (mLSTM and sLSTM mixers, ``xlstm-350m``) against the
JAX package's.

Both packages get the same numpy inputs; LM-level tests run
``xlstm-350m``'s ``reduced()`` config (6 layers, 5 mLSTM then 1 sLSTM,
d = 256, 4 heads of mLSTM width 128, fp32) with the reference's params
carried over by ``convert.load_lm_reference``.

Tolerances:

- The mLSTM's two sequence forms, port against reference: atol 1e-5,
  rtol 1e-5 (the same fp32 math summed in other orders). The port's
  chunked form against its quadratic one: the reference's own 2e-4 /
  1e-3 (``tests/test_models_consistency.py``).
- Blocks with their states: fp32 ``BLOCK_TOL`` (1e-5); bf16 atol 2e-2,
  rtol 3e-2. The bf16 promotion (k divided in fp32, the gates against the
  fp32 ``w_if`` in fp32, h_{t−1} rounded to bf16 before ``r_gates``) is
  pinned exactly, with weights whose products are exact in both dtypes.
- LM logits and caches: ``test_torch_lm``'s TOL (atol 5e-5, rtol 1e-4)
  on the quadratic form (≤ 256 tokens without a state), and
  ``LONG_TOL`` wherever a sequence runs past a few tens of tokens.
  The reduced xLSTM is ill-conditioned in fp32: the mLSTM weighs the
  values by signed q·k terms, whose sums cancel. At 300 tokens the two
  packages' logits part by 2.5e-4–3.5e-4 (seeds 0, 1), and the port's own
  logits move by 1.8e-4–3.8e-4 when every weight is scaled by
  1 + 6e-8·N(0, 1), about one ulp (``test_torch_xlstm_probe.py``). So
  the packages agree to the model's own rounding; ``LONG_TOL`` leaves
  ~3x over it, and a fault in the forms, the state or the gates moves
  the logits by ≥ 1e-2.
- RWSADMM steps: the loss at ``test_torch_train_step``'s STEP_TOL; x, z
  and y at STEP_TOL plus ``GRAD_SHARE`` of the leaf's step (its largest
  |new − old| in the reference). The same conditioning reaches the
  gradients: the packages' gradients part by up to 8.2e-5–1.2e-4 of a
  leaf's largest entry, the port's own by 5.7e-5–8.9e-5 under the
  one-ulp scaling above, while x, z and y move by the gradient times
  1/β, κ and 1/(βn). Sign flips of y' − x must be ties (|y' − x| within
  both sides' tolerance) and few, counting only those above ``DEEP_TIE``
  of a tie: below it y' − x is the gradient's own rounding (the sLSTM's
  gate biases get gradients of ~1e-11 from sums of ~1e-4 terms, as the
  exp-stabilised gates cancel), and its sign comes out either way, in
  about half of such elements.
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
from repro.models import recurrent as R
from repro.models.registry import build_model as ref_build
from repro.models.registry import random_batch as ref_batch
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.launch import serve, steps
from repro_torch.models import recurrent as P
from repro_torch.models.registry import build_model, random_batch
from test_torch_lm import TOL, _np, _ref_greedy, lm_state_to_reference
from test_torch_train_step import HP, MAX_FLIP_SHARE, N_TOTAL, STEP_TOL, \
    _as_port
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "xlstm-350m"
FULL_COUNT = 518_651_904
FORM_TOL = dict(atol=1e-5, rtol=1e-5)
FORMS_TOL = dict(atol=2e-4, rtol=1e-3)
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=3e-2)
BF16_LOSS_RTOL = 1e-2
LONG_TOL = dict(atol=1e-3, rtol=1e-4)
EXACT = dict(atol=1e-6, rtol=1e-6)
#: a step's tolerance beyond STEP_TOL, as a share of the leaf's step
GRAD_SHARE = 3e-4
#: |y' − x| below this share of the tie: the sign is rounding noise
DEEP_TIE = 1e-3


def _configs(dtype="float32"):
    return (dataclasses.replace(ref_config(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype))


@pytest.fixture(scope="module")
def pair():
    """Reference model and params (seed 0), and the port's LM holding
    them."""
    rcfg, cfg = _configs()
    ref = ref_build(rcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    ref.init(jax.random.PRNGKey(0)))
    port = build_model(cfg, device="cpu")
    convert.load_lm_reference(port, params)
    return rcfg, cfg, ref, params, port


def _tokens(rcfg, seq, seed):
    tokens = ref_batch(rcfg, 2, seq, seed=seed)["tokens"]
    return tokens, {"tokens": torch.as_tensor(np.asarray(tokens))}


# ---------------------------------------------------------- the forms --
def _form_inputs(seed=0, b=2, s=64, h=4, hd=32):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, s, h, hd))
    k = rng.normal(0, 1, (b, s, h, hd)) / np.sqrt(hd)
    v = rng.normal(0, 1, (b, s, h, hd))
    log_i = rng.normal(0, 1, (b, s, h))
    log_f = -np.log1p(np.exp(-rng.normal(2, 1, (b, s, h))))
    return [t.astype(np.float32) for t in (q, k, v, log_i, log_f)]


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_mlstm_forms_match_reference(chunk):
    """Both forms against the reference's at 64 tokens (48 pads the last
    chunk with 32 tokens), with the chunked form's final state; then the
    port's two forms against each other."""
    arrays = _form_inputs(seed=chunk)
    ref_in = [jnp.asarray(a) for a in arrays]
    port_in = [torch.as_tensor(a) for a in arrays]
    quad = P._mlstm_quadratic(*port_in)
    np.testing.assert_allclose(quad.numpy(),
                               np.asarray(R._mlstm_quadratic(*ref_in)),
                               **FORM_TOL)
    h_r, state_r = R._mlstm_chunked(*ref_in, chunk, return_state=True)
    h_p, state_p = P._mlstm_chunked(*port_in, chunk)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_r), **FORM_TOL)
    for got, want in zip(state_p, state_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **FORM_TOL)
    np.testing.assert_allclose(h_p.numpy(), quad.numpy(), **FORMS_TOL)


# --------------------------------------------------------- the blocks --
BLOCKS = {"mlstm": (R.mlstm_init, P.MLSTM, R.mlstm_block, P.mlstm_block,
                    R.mlstm_decode_step, P.mlstm_decode_step),
          "slstm": (R.slstm_init, P.SLSTM, R.slstm_block, P.slstm_block,
                    R.slstm_decode_step, P.slstm_decode_step)}


def _block_pair(kind, dtype, seed=0):
    rcfg, cfg = _configs(dtype)
    init_r, module, *_ = BLOCKS[kind]
    params = jax.tree_util.tree_map(
        np.asarray, init_r(jax.random.PRNGKey(seed), rcfg))
    mix = module(cfg, device="cpu")
    convert.load_reference(mix, params)
    return rcfg, cfg, params, mix


def _x(cfg, s, dtype, seed=1):
    x = np.random.default_rng(seed).normal(
        0, 1, (2, s, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(x, dtype=dtype),
            torch.as_tensor(x).to(getattr(torch, dtype)))


def _hold(got, want, tol, what):
    assert got.dtype == getattr(torch, str(want.dtype)), what
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol,
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_and_state_match_reference(kind, dtype):
    """The block over 40 tokens with its state (the mLSTM in chunks of 16,
    the last padded), then five decode steps from that state: outputs and
    every state field in the reference's dtypes."""
    rcfg, cfg, params, mix = _block_pair(kind, dtype)
    _, _, block_r, block_p, step_r, step_p = BLOCKS[kind]
    tol = BLOCK_TOL if dtype == "float32" else BF16_TOL
    x_r, x_p = _x(cfg, 45, dtype)
    kw = {"chunk": 16} if kind == "mlstm" else {}
    out_r, st_r = block_r(params, x_r[:, :40], rcfg, return_state=True, **kw)
    with torch.no_grad():
        out_p, st_p = block_p(mix, x_p[:, :40], cfg, return_state=True,
                              **kw)
    _hold(out_p, out_r, tol, "block output")
    for field, got in zip(st_p._fields, st_p):
        _hold(got, getattr(st_r, field), tol, field)
    for t in range(40, 45):
        out_r, st_r = step_r(params, x_r[:, t:t + 1], st_r, rcfg)
        with torch.no_grad():
            out_p, st_p = step_p(mix, x_p[:, t:t + 1], st_p, cfg)
        _hold(out_p, out_r, tol, f"decode output {t}")
        for field, got in zip(st_p._fields, st_p):
            _hold(got, getattr(st_r, field), tol, f"decode {field} {t}")


def _exact_weights(shape, rng, scale=1.0):
    """One nonzero a column, ``scale`` or −``scale``: a product with it
    is exact in any dtype that holds ``scale``·x."""
    w = np.zeros(shape, np.float32)
    rows = rng.integers(0, shape[0], shape[1])
    w[rows, np.arange(shape[1])] = scale * rng.choice([-1.0, 1.0],
                                                      shape[1])
    return w


def test_bf16_promotion_is_the_reference_s():
    """In a bf16 model, exactly as the reference (to a few fp32 ulps):
    the mLSTM divides k by √hd in fp32 and takes its gates against the
    fp32 ``w_if`` in fp32 (a w_if entry 1 + 2⁻¹² does not fit bf16); the
    sLSTM rounds h_{t−1} to bf16 before ``r_gates``. One decode step from
    the initial state makes the mLSTM's n equal k and m equal log i."""
    rng = np.random.default_rng(0)
    rcfg, cfg, params, mix = _block_pair("mlstm", "bfloat16")
    d, di = cfg.d_model, 2 * cfg.d_model
    params = dict(params)
    for name, shape in (("w_up", (d, di)), ("w_gate_up", (d, di)),
                        ("wq", (di, di)), ("wk", (di, di)),
                        ("wv", (di, di)), ("w_down", (di, d))):
        params[name] = _exact_weights(shape, rng).astype(jnp.bfloat16)
    params["w_if"] = _exact_weights((di, 2 * cfg.n_heads), rng,
                                    1 + 2.0 ** -12)
    convert.load_reference(mix, params)
    assert mix.w_if.dtype == torch.float32
    x_r, x_p = _x(cfg, 1, "bfloat16", seed=2)
    _, st_r = R.mlstm_decode_step(params, x_r, R.mlstm_init_state(rcfg, 2),
                                  rcfg)
    with torch.no_grad():
        _, st_p = P.mlstm_decode_step(
            mix, x_p, P.mlstm_init_state(cfg, 2), cfg)
    for field in ("c", "n", "m"):
        _hold(getattr(st_p, field), getattr(st_r, field), EXACT, field)

    rcfg, cfg, params, mix = _block_pair("slstm", "bfloat16")
    params = dict(params, w_gates=_exact_weights((d, 4 * d), rng)
                  .astype(jnp.bfloat16),
                  r_gates=_exact_weights((d, 4 * d), rng)
                  .astype(jnp.bfloat16),
                  b_gates=rng.normal(0, 1, 4 * d).astype(np.float32))
    convert.load_reference(mix, params)
    state = [rng.normal(0, 1, (2, d)).astype(np.float32) for _ in range(4)]
    st_r = R._slstm_cell(params, x_r[:, 0],
                         R.SLSTMState(*map(jnp.asarray, state)))
    with torch.no_grad():
        st_p = P._slstm_cell(mix, (x_p[:, 0] @ mix.w_gates).float(),
                             P.SLSTMState(*map(torch.as_tensor, state)),
                             torch.bfloat16, torch.ones(()))
    for field, got in zip(st_p._fields, st_p):
        _hold(got, getattr(st_r, field), EXACT, field)


# ------------------------------------------------------------- the LM --
def test_builds_with_reference_dtypes_and_count():
    """``xlstm-350m`` is registered with the reference's count; a bf16
    model keeps ``w_if`` and ``b_gates`` in fp32 and has no FFN."""
    assert get_config(ARCH).param_count() == \
        ref_config(ARCH).param_count() == FULL_COUNT
    rcfg, cfg = _configs("bfloat16")
    assert cfg.param_count() == rcfg.param_count()
    port = build_model(cfg, device="cpu")
    kinds = [blk.kind for blk in port.layers]
    assert kinds == ["mlstm"] * 5 + ["slstm"]
    dtypes = {n.split(".", 3)[-1]: p.dtype
              for n, p in port.named_parameters() if n.startswith("layers")}
    assert dtypes.pop("w_if") == dtypes.pop("b_gates") == torch.float32
    assert set(dtypes.values()) == {torch.bfloat16}
    assert not any(hasattr(blk, "ffn") for blk in port.layers)


@pytest.mark.parametrize("seq, tol", [(12, TOL), (300, LONG_TOL)],
                         ids=["12-quadratic", "300-chunked"])
def test_apply_logits_match_reference(pair, seq, tol):
    rcfg, cfg, ref, params, port = pair
    tokens, batch = _tokens(rcfg, seq, seed=3)
    want = ref.apply(params, {"tokens": tokens})
    with torch.no_grad():
        got = port.apply(batch)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("prompt", [40, 300])
def test_prefill_logits_and_caches_match_reference(pair, prompt):
    """Prefill runs the chunked form at every length: logits and every
    layer's state as the reference's."""
    rcfg, cfg, ref, params, port = pair
    tokens, batch = _tokens(rcfg, prompt, seed=4)
    logits_r, cache_r = ref.prefill(params, {"tokens": tokens}, prompt + 8)
    logits_p, cache_p = port.prefill(batch, prompt + 8)
    np.testing.assert_allclose(_np(logits_p), _np(logits_r), **LONG_TOL)
    assert cache_p["step"] == int(cache_r["step"]) == prompt
    g = len(cfg.layer_pattern)
    for layer, got in enumerate(cache_p["layers"]):
        want = cache_r["groups"][layer % g]
        assert type(got).__name__ == type(want).__name__
        for field in got._fields:
            np.testing.assert_allclose(
                _np(getattr(got, field)),
                _np(getattr(want, field))[layer // g], **LONG_TOL,
                err_msg=f"layer {layer} {field}")


def test_greedy_decode_matches_reference(pair):
    """A 40-token prompt, then 24 greedy steps through ``serve.generate``:
    ids equal, logits at ``LONG_TOL``."""
    rcfg, cfg, ref, params, port = pair
    tokens, batch = _tokens(rcfg, 40, seed=5)
    ids_r, logits_r = _ref_greedy(ref, params, tokens, 24, 64)
    ids_p, logits_p = zip(*serve.generate(port, batch, 24, 64))
    np.testing.assert_allclose(torch.stack(logits_p, 1).numpy(), logits_r,
                               **LONG_TOL)
    assert np.array_equal(torch.cat(ids_p, 1).numpy(), ids_r)


def test_decode_matches_teacher_forced_apply(pair):
    """Inside the port: prefill 40 tokens (chunked), feed 40 more one at a
    time; each step's logits equal ``apply`` over all 80 (quadratic) at
    that position."""
    _, cfg, _, _, port = pair
    tokens = random_batch(cfg, 2, 80, seed=6, device="cpu")["tokens"]
    with torch.no_grad():
        full = port.apply({"tokens": tokens})
        logits, cache = port.prefill({"tokens": tokens[:, :40]}, 80)
        torch.testing.assert_close(logits, full[:, :40], **LONG_TOL)
        for t in range(40, 80):
            lg, cache = port.decode_step(cache, tokens[:, t:t + 1])
            torch.testing.assert_close(lg, full[:, t], **LONG_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_params_round_trip(dtype):
    """Reference params → port LM → reference params, exactly; in bf16
    ``w_if`` and ``b_gates`` stay fp32 on both sides."""
    rcfg, cfg = _configs(dtype)
    params = jax.tree_util.tree_map(
        np.asarray, ref_build(rcfg).init(jax.random.PRNGKey(1)))
    port = build_model(cfg, device="cpu")
    convert.load_lm_reference(port, params)
    for gi, kind in enumerate(cfg.layer_pattern):
        mix = port.layers[gi].mix
        fp32 = ("w_if",) if kind == "mlstm" else ("b_gates",)
        for name, p in mix.named_parameters():
            want = torch.float32 if name in fp32 else getattr(torch, dtype)
            assert p.dtype == want, (kind, name)
            assert str(params["layers"][gi]["mix"][name].dtype) == \
                str(want).split(".")[1]
    back = lm_state_to_reference(port.state_dict(), cfg)
    same = jax.tree_util.tree_map(
        lambda a, b: np.array_equal(a.astype(np.float32), b), params, back)
    assert jax.tree_util.tree_all(same)


def test_entry_points_need_a_gpu_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", ARCH, "--reduced", "--gen", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.load_model(ARCH, reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(_configs()[1])


# ---------------------------------------------------------- training --
def _step_atol(prev: dict, new: dict) -> dict:
    """Each leaf's absolute tolerance: STEP_TOL's plus ``GRAD_SHARE`` of
    its step in the reference."""
    return {leaf: STEP_TOL["atol"] + GRAD_SHARE * float(
        (new[leaf].float() - prev[leaf].float()).abs().max())
        for leaf in new}


@pytest.mark.parametrize("seq", [12, 300], ids=["12-quadratic",
                                                "300-chunked"])
def test_train_steps_match_reference(pair, seq):
    """Two RWSADMM steps of ``make_train_step``, each from the reference's
    state before it: loss and κ at STEP_TOL, x, z and y at STEP_TOL plus
    ``GRAD_SHARE`` of each leaf's step, with sign flips of y' − x at ties
    left out and, above ``DEEP_TIE``, few."""
    rcfg, cfg, ref, params, port = pair
    r_step = jax.jit(ref_steps.make_train_step(ref, RHP(**HP), N_TOTAL))
    step = steps.make_train_step(port, RWSADMMHparams(**HP), N_TOTAL)
    r_st = ref_steps.init_train_state(params, RHP(**HP))
    for t in range(2):
        tokens, batch = _tokens(rcfg, seq, seed=20 + t)
        prev = {n: _as_port(getattr(r_st, n), cfg) for n in ("x", "z", "y")}
        st = steps.TrainState(**prev, kappa=torch.tensor(float(r_st.kappa)))
        r_next, r_loss = r_step(r_st, {"tokens": tokens})
        st, loss = step(st, batch)
        np.testing.assert_allclose(float(loss), float(r_loss), **STEP_TOL)
        np.testing.assert_allclose(float(st.kappa), float(r_next.kappa),
                                   rtol=1e-7)
        want = {n: _as_port(getattr(r_next, n), cfg) for n in ("x", "z", "y")}
        atol = {n: _step_atol(prev[n], want[n]) for n in want}
        flips = {}
        for leaf, y0 in prev["y"].items():
            # sgn(y' − x) may come out otherwise where x lies on y' within
            # both sides' tolerance of x
            gap = (y0 - want["x"][leaf]).abs() / (
                2 * (atol["x"][leaf] + STEP_TOL["rtol"] * y0.abs()))
            flip = torch.sign(y0 - want["x"][leaf]) != torch.sign(
                y0 - st.x[leaf])
            assert bool((gap[flip] <= 1).all()), (leaf, gap[flip])
            counted = int((flip & (gap > DEEP_TIE)).sum())
            assert counted <= MAX_FLIP_SHARE * flip.numel() + 1, leaf
            flips[leaf] = flip
        for name in ("x", "z", "y"):
            got = getattr(st, name)
            assert set(got) == set(want[name])
            for leaf, w in want[name].items():
                assert got[leaf].dtype == w.dtype, (name, leaf)
                keep = ~flips[leaf]
                np.testing.assert_allclose(
                    got[leaf][keep].numpy(), w[keep].numpy(),
                    atol=atol[name][leaf], rtol=STEP_TOL["rtol"],
                    err_msg=f"step {t} {name} {leaf}")
        assert any(bool(v.abs().max() > 0) for v in st.z.values())
        r_st = r_next


def test_bf16_steps_follow_reference_promotion():
    """Two bf16 steps on 12 tokens, each from the reference's state before
    it (its bf16 weights first): every leaf of x, z and y in the
    reference's dtype (x keeps its own, bf16 or
    the fp32 ``w_if`` and ``b_gates``, for one step; z and y are fp32 from
    the first) and the losses within ``BF16_LOSS_RTOL``. The values are
    held in fp32 (``test_train_steps_match_reference``): in bf16 the two
    packages' gradients part by tens of percent in places (the
    conditioning above at bf16's 2⁻⁸), and x with them."""
    rcfg, cfg = _configs("bfloat16")
    ref = ref_build(rcfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = build_model(cfg, device="cpu")
    r_step = jax.jit(ref_steps.make_train_step(ref, RHP(**HP), N_TOTAL))
    step = steps.make_train_step(port, RWSADMMHparams(**HP), N_TOTAL)
    r_st = ref_steps.init_train_state(params, RHP(**HP))
    for t in range(2):
        tokens, batch = _tokens(rcfg, 12, seed=30 + t)
        st = steps.TrainState(*(_as_port(getattr(r_st, n), cfg)
                                for n in ("x", "z", "y")),
                              kappa=torch.tensor(float(r_st.kappa)))
        r_st, r_loss = r_step(r_st, {"tokens": tokens})
        st, loss = step(st, batch)
        np.testing.assert_allclose(float(loss), float(r_loss),
                                   rtol=BF16_LOSS_RTOL)
        for name in ("x", "z", "y"):
            want = _as_port(getattr(r_st, name), cfg)
            assert {k: v.dtype for k, v in getattr(st, name).items()} == \
                {k: v.dtype for k, v in want.items()}, (t, name)
        assert str(st.x["layers.0.mix.w_up"].dtype) == \
            ("torch.bfloat16", "torch.float32")[t]
        assert st.x["layers.0.mix.w_if"].dtype == torch.float32
