"""The model zoo in the port against the JAX package's: gemma3-12b
(5 local : 1 global, GELU, tied), tinyllama-1.1b (untied head), qwen2-7b
(qkv bias, untied head), yi-34b (untied head) and xlstm-350m (5 mLSTM :
1 sLSTM, no FFN, untied head; its own file is ``test_torch_xlstm.py``).

Each arch's ``reduced()`` config (fp32, d = 256, 4 heads over 2 KV
heads; gemma3 keeps its 6-layer pattern with window 64) runs in both
packages with the reference's params carried over by
``convert.load_lm_reference``; the qkv biases, zeros at init, are drawn
at random first so that the port must add them. Logits agree at
``test_torch_lm``'s TOL (atol 5e-5, rtol 1e-4; the same fp32 math summed
in other orders), caches likewise, greedy ids exactly. gemma3's local
rings wrap in prefill (a 100-token prompt) and in decode (2 × window
steps after a 20-token prompt). The xLSTM's logits are held at
``test_torch_xlstm``'s LONG_TOL past a few tens of tokens: in fp32 its
signed mLSTM sums cancel, and the two packages agree there to their own
rounding (that file's docstring gives the measurements).
"""
import dataclasses
import importlib.util
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.registry import build_model as ref_build
from repro.models.registry import random_batch as ref_batch
from repro_torch import convert
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import serve
from repro_torch.models.registry import build_model, random_batch
from test_torch_lm import TOL, _np, _ref_greedy, lm_state_to_reference
from test_torch_xlstm import LONG_TOL
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["gemma3-12b", "tinyllama-1.1b", "qwen2-7b", "yi-34b",
         "xlstm-350m"]
ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the reference's count at full width (its formula, as the port's)
FULL_COUNTS = {"gemma3-12b": 8_793_047_040, "tinyllama-1.1b": 1_100_136_448,
               "qwen2-7b": 7_615_813_632, "yi-34b": 34_389_770_240,
               "xlstm-350m": 518_651_904}


def _logits_tol(arch):
    return LONG_TOL if arch == "xlstm-350m" else TOL


def _pair(arch, seed=0):
    """Reference model and params (random qkv biases), and the port's LM
    holding them."""
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    ref = ref_build(rcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    ref.init(jax.random.PRNGKey(seed)))
    if rcfg.qkv_bias:
        rng = np.random.default_rng(seed)
        for group in params["layers"]:
            for b in ("bq", "bk", "bv"):
                group["mix"][b] = rng.normal(
                    0, 0.5, group["mix"][b].shape).astype(np.float32)
    port = build_model(cfg, device="cpu")
    convert.load_lm_reference(port, params)
    return rcfg, cfg, ref, params, port


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    """The analytic count equals the reference's at full and reduced
    size; the built parameters equal the reference's, which its formula
    overcounts by a norm a layer (two with an FFN: it counts the FFN's
    norm twice) less the final norm."""
    assert arch in list_archs()
    full = get_config(arch)
    assert full.param_count() == ref_config(arch).param_count() \
        == FULL_COUNTS[arch]
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    assert cfg.param_count() == rcfg.param_count()
    shapes = jax.eval_shape(ref_build(rcfg).init, jax.random.PRNGKey(0))
    ref_total = sum(x.size for x in jax.tree_util.tree_leaves(shapes))
    port = build_model(cfg, device="cpu")
    built = sum(p.numel() for p in port.parameters())
    norms = 2 if cfg.d_ff else 1
    assert built == ref_total == cfg.param_count() - cfg.d_model * (
        norms * cfg.n_layers - 1)
    assert hasattr(port, "head") == (not cfg.tie_embeddings)
    assert hasattr(port.layers[0].mix, "bq") == cfg.qkv_bias


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_logits_match_reference(arch):
    rcfg, cfg, ref, params, port = _pair(arch)
    want = ref.apply(params, ref_batch(rcfg, 2, 100, seed=3))
    with torch.no_grad():
        got = port.apply(random_batch(cfg, 2, 100, seed=3, device="cpu"))
    np.testing.assert_allclose(_np(got), _np(want), **_logits_tol(arch))


@pytest.mark.parametrize("prompt", [40, 100])
@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen2-7b"])
def test_prefill_logits_and_caches_match_reference(arch, prompt):
    """A prompt shorter and one longer than gemma3's 64-token window: the
    local rings, the global caches and the logits as the reference's."""
    rcfg, cfg, ref, params, port = _pair(arch)
    tokens = ref_batch(rcfg, 2, prompt, seed=4)["tokens"]
    logits_r, cache_r = ref.prefill(params, {"tokens": tokens}, 200)
    logits_p, cache_p = port.prefill(
        {"tokens": torch.tensor(np.asarray(tokens))}, 200)
    np.testing.assert_allclose(_np(logits_p), _np(logits_r), **TOL)
    assert cache_p["step"] == int(cache_r["step"]) == prompt
    g = len(cfg.layer_pattern)
    for layer, got in enumerate(cache_p["layers"]):
        want = cache_r["groups"][layer % g]
        assert got.length == prompt == int(want.length[layer // g])
        for field in ("k", "v"):
            np.testing.assert_allclose(_np(getattr(got, field)),
                                       _np(getattr(want, field))[layer // g],
                                       **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_reference_past_the_window(arch):
    """2 × window decode steps after a 20-token prompt (gemma3's rings
    wrap at step 44): logits at TOL and greedy ids exactly equal."""
    rcfg, cfg, ref, params, port = _pair(arch)
    tokens = ref_batch(rcfg, 2, 20, seed=5)["tokens"]
    gen = 2 * cfg.window
    ids_r, logits_r = _ref_greedy(ref, params, tokens, gen, 20 + gen)
    steps = serve.generate(port,
                           {"tokens": torch.tensor(np.asarray(tokens))},
                           gen, 20 + gen)
    ids_p, logits_p = zip(*steps)
    np.testing.assert_allclose(torch.stack(logits_p, 1).numpy(), logits_r,
                               **_logits_tol(arch))
    assert np.array_equal(torch.cat(ids_p, 1).numpy(), ids_r)


@pytest.mark.parametrize("arch", ["qwen2-7b", "tinyllama-1.1b"])
def test_bias_and_head_round_trip(arch):
    """The qkv bias and the untied head go reference → port → reference
    exactly (``test_apply_logits_match_reference`` holds that the port
    adds the bias and reads the head), and a head of the wrong shape is
    refused by name."""
    rcfg, cfg, ref, params, port = _pair(arch)
    back = lm_state_to_reference(port.state_dict(), cfg)
    same = jax.tree_util.tree_map(lambda a, b: np.array_equal(a, b),
                                  params, back)
    assert jax.tree_util.tree_all(same)
    assert tuple(port.head.shape) == (cfg.d_model, cfg.vocab)
    bad = dict(params, head=params["head"][:, :8])
    with pytest.raises(ValueError, match="head"):
        convert.load_lm_reference(port, bad)


def test_only_standard_rope_runs():
    """Every rope mode runs on an attention stack: "mrope" (text tokens on
    all three tracks) and "none" (the learned position table) build, hold
    the reference's params and give its logits, and count as it does."""
    for rope in ("mrope", "none"):
        rcfg = dataclasses.replace(ref_config("tinyllama-1.1b").reduced(),
                                   rope=rope)
        cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                                  rope=rope)
        assert cfg.param_count() == rcfg.param_count()
        ref = ref_build(rcfg)
        params = jax.tree_util.tree_map(np.asarray,
                                        ref.init(jax.random.PRNGKey(1)))
        port = build_model(cfg, device="cpu")
        convert.load_lm_reference(port, params)
        assert hasattr(port, "pos_embed") == (rope == "none")
        batch = ref_batch(rcfg, 2, 24, seed=2)
        with torch.no_grad():
            got = port.apply(random_batch(cfg, 2, 24, seed=2, device="cpu"))
        np.testing.assert_allclose(_np(got), _np(ref.apply(params, batch)),
                                   **TOL)


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_example_matches_reference_example(monkeypatch, capsys):
    """``examples/serve_personalized_torch.py`` (gemma3-12b reduced) with
    the reference example's weights prints the reference example's
    requests, line for line."""
    monkeypatch.setattr(sys, "argv", ["serve_personalized.py"])
    _load_example("serve_personalized").main()
    want = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("request")]
    rcfg = ref_config("gemma3-12b").reduced()
    params = ref_build(rcfg).init(jax.random.PRNGKey(0))
    state = convert.lm_state_from_reference(
        jax.tree_util.tree_map(np.asarray, params), rcfg)
    ids = _load_example("serve_personalized_torch").main(
        ["--device", "cpu"], params=state)
    out = capsys.readouterr().out
    got = [line for line in out.splitlines() if line.startswith("request")]
    assert tuple(ids.shape) == (4, 24)
    assert got == want and len(got) == 4
    assert "prefill 4×32" in out and "tok/s" in out


def test_serve_example_needs_a_gpu_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load_example("serve_personalized_torch").main(["--gen", "2"])
