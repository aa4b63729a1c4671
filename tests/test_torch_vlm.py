"""The vision stub (qwen2-vl-2b: projected patch embeddings ahead of the
text, M-RoPE) and learned positions (``rope="none"`` on attention) in
the port against the JAX package's.

qwen2-vl-2b's ``reduced()`` config (fp32, d = 256, 2 layers, 4 heads
over 2 KV heads, 16 patches on a 4 × 4 grid) runs in both packages with
the reference's params carried over by ``convert.load_lm_reference``;
the qkv biases, zeros at init, are drawn at random first so that the
port must add them. M-RoPE rotates three sections of hd (hd/2, hd/4,
hd/4), each a RoPE of its own width by its own position track. Logits
and caches agree at ``test_torch_lm``'s TOL, positions and greedy ids
exactly.
"""
import dataclasses
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import steps as ref_steps
from repro.models import layers as ref_layers
from repro.models.registry import build_model as ref_build
from repro.models.registry import random_batch as ref_batch
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models.registry import build_model, random_batch
from repro_torch.models.transformer import LM
from test_torch_lm import TOL, _np
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "qwen2-vl-2b"
ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the reference's count at full width (its formula, as the port's), and
#: the parameters both packages build: the formula leaves out the
#: projector's d² = 2,359,296 and the final norm, and counts each
#: layer's 2·d of norms twice
FULL_COUNT = 1_543_798_784
FULL_BUILT = 1_546_073_600
#: an attention stack without RoPE: tinyllama's reduced config with the
#: reference's learned position table
ROPELESS = ("tinyllama-1.1b", dict(rope="none"))


def _pair(arch=ARCH, seed=0, **replace):
    """Reference model and params (random qkv biases), and the port's LM
    holding them."""
    rcfg = dataclasses.replace(ref_config(arch).reduced(), **replace)
    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
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


def _to_torch(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def test_param_count_matches_reference():
    full_r, full = ref_config(ARCH), get_config(ARCH)
    assert full.param_count() == full_r.param_count() == FULL_COUNT
    shapes = jax.eval_shape(ref_build(full_r).init, jax.random.PRNGKey(0))
    assert sum(x.size for x in jax.tree_util.tree_leaves(shapes)) \
        == FULL_BUILT
    assert sum(p.numel() for p in LM(full, device="meta").parameters()) \
        == FULL_BUILT
    for arch, replace in ((ARCH, {}), ROPELESS):
        rcfg = dataclasses.replace(ref_config(arch).reduced(), **replace)
        cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
        assert cfg.param_count() == rcfg.param_count()
        shapes = jax.eval_shape(ref_build(rcfg).init, jax.random.PRNGKey(0))
        assert sum(p.numel() for p in build_model(cfg, device="cpu")
                   .parameters()) == sum(
            x.size for x in jax.tree_util.tree_leaves(shapes))


@pytest.mark.parametrize("hd", [64, 40, 128])
def test_apply_mrope_matches_reference(hd):
    """Three sections (hd/2, hd/4, hd/4) each rotated by its own track at
    its own width's frequencies; a text position on all three tracks is
    RoPE on each section."""
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 9, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 5000, (3, 2, 9))
    got = layers.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), 1e6)
    want = ref_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    text = rng.integers(0, 5000, (2, 9))
    tracks = layers.text_mrope_positions(torch.as_tensor(text))
    assert np.array_equal(tracks.numpy(), np.asarray(
        ref_layers.text_mrope_positions(jnp.asarray(text))))
    got = layers.apply_mrope(torch.as_tensor(x), tracks, 1e6)
    sec = (hd // 2, hd // 4, hd - hd // 2 - hd // 4)
    parts = np.split(x, np.cumsum(sec)[:-1], axis=-1)
    want = np.concatenate([np.asarray(ref_layers.apply_rope(
        jnp.asarray(p), jnp.asarray(text), 1e6)) for p in parts], -1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_random_batch_patches_match_reference():
    rcfg, cfg = ref_config(ARCH).reduced(), get_config(ARCH).reduced()
    for dtype in ("float32", "bfloat16"):
        want = ref_batch(dataclasses.replace(rcfg, dtype=dtype), 3, 10,
                         seed=9)
        got = random_batch(dataclasses.replace(cfg, dtype=dtype), 3, 10,
                           seed=9, device="cpu")
        assert set(got) == set(want) == {"tokens", "patches"}
        for k in want:
            assert np.array_equal(got[k].float().numpy(),
                                  np.asarray(want[k]).astype(np.float32))


@pytest.mark.parametrize("arch,replace", [(ARCH, {}), ROPELESS])
def test_inputs_apply_and_loss_match_reference(arch, replace):
    """The assembled inputs (patches through the projector ahead of the
    text, or the learned position table added), the positions (M-RoPE's
    three tracks exactly), the logits over S_total and the loss over the
    text span."""
    rcfg, cfg, ref, params, port = _pair(arch, **replace)
    batch = ref_batch(rcfg, 2, 20, seed=3)
    h_r, pos_r, off_r = ref._assemble_inputs(params, batch)
    with torch.no_grad():
        h, pos, off = port._assemble_inputs(_to_torch(batch))
        logits = port.apply(_to_torch(batch))
        loss = port.loss(_to_torch(batch))
    assert off == off_r == cfg.n_patches
    assert np.array_equal(pos.numpy(), np.asarray(pos_r))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), **TOL)
    want = np.asarray(ref.apply(params, batch))
    assert logits.shape == want.shape == (2, 20 + cfg.n_patches, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), want, **TOL)
    np.testing.assert_allclose(float(loss), float(ref.loss(params, batch)),
                               rtol=1e-6)


@pytest.mark.parametrize("arch,replace", [(ARCH, {}), ROPELESS])
def test_prefill_matches_reference(arch, replace):
    rcfg, cfg, ref, params, port = _pair(arch, **replace)
    batch = ref_batch(rcfg, 2, 20, seed=4)
    max_len = 20 + 8 + cfg.n_patches
    logits_r, cache_r = ref.prefill(params, batch, max_len)
    logits_p, cache_p = port.prefill(_to_torch(batch), max_len)
    np.testing.assert_allclose(_np(logits_p), _np(logits_r), **TOL)
    assert cache_p["step"] == int(cache_r["step"]) == 20 + cfg.n_patches
    for layer, got in enumerate(cache_p["layers"]):
        want = cache_r["groups"][0]
        assert got.length == cache_p["step"]
        for field in ("k", "v"):
            np.testing.assert_allclose(_np(getattr(got, field)),
                                       _np(getattr(want, field))[layer],
                                       **TOL)


def _ref_greedy(ref, params, batch, gen, max_len):
    """The reference's greedy loop (its serve.py's), keeping logits."""
    prefill = jax.jit(lambda p, b: ref.prefill(p, b, max_len))
    logits, cache = prefill(params, batch)
    logits = [np.asarray(logits[:, -1])]
    step = jax.jit(ref.decode_step)
    ids = [logits[0].argmax(-1)[:, None].astype(np.int32)]
    for _ in range(gen - 1):
        lg, cache = step(params, cache, ids[-1])
        logits.append(np.asarray(lg))
        ids.append(logits[-1].argmax(-1)[:, None].astype(np.int32))
    return np.concatenate(ids, 1), np.stack(logits, 1)


@pytest.mark.parametrize("arch,replace", [(ARCH, {}), ROPELESS])
def test_greedy_decode_matches_reference(arch, replace):
    """16 greedy steps after a 20-token prompt (and the patches): logits at
    TOL and ids exactly; decode positions carry on from S_total on all
    three M-RoPE tracks, or read the position table's row."""
    rcfg, cfg, ref, params, port = _pair(arch, **replace)
    batch = ref_batch(rcfg, 2, 20, seed=5)
    gen = 16
    max_len = serve.max_len_for(cfg, 20, gen)
    ids_r, logits_r = _ref_greedy(ref, params, batch, gen, max_len)
    ids_p, logits_p = zip(*serve.generate(port, _to_torch(batch), gen,
                                          max_len))
    np.testing.assert_allclose(torch.stack(logits_p, 1).numpy(), logits_r,
                               **TOL)
    assert np.array_equal(torch.cat(ids_p, 1).numpy(), ids_r)


def test_decode_matches_teacher_forced_apply():
    """Inside the port: prefill the patches and 10 tokens, then feed 10
    more one at a time; each step's logits equal ``apply`` over the whole
    sequence at that position."""
    _, cfg, _, _, port = _pair(seed=1)
    batch = random_batch(cfg, 2, 20, seed=6, device="cpu")
    off = cfg.n_patches
    with torch.no_grad():
        full = port.apply(batch)
        logits, cache = port.prefill(
            {"tokens": batch["tokens"][:, :10], "patches": batch["patches"]},
            off + 20)
        torch.testing.assert_close(logits, full[:, :off + 10], **TOL)
        for t in range(10, 20):
            lg, cache = port.decode_step(cache, batch["tokens"][:, t:t + 1])
            torch.testing.assert_close(lg, full[:, off + t], **TOL)


def test_serve_main_matches_reference_loop(capsys):
    """``serve.main`` on the CPU with the vision stub: the port's seeded
    weights, carried back to the reference, give the same ids through the
    reference's own prefill and serve steps (max_len counts the
    patches)."""
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "20", "--gen", "8", "--device", "cpu", "--seed", "0"]
    ids = serve.main(argv)
    assert "tok/s" in capsys.readouterr().out
    assert tuple(ids.shape) == (2, 8)
    rcfg = ref_config(ARCH).reduced()
    port = serve.load_model(ARCH, reduced=True, device="cpu", seed=0)
    params = jax.tree_util.tree_map(lambda t: t.numpy(),
                                    convert.reference_tree(port))
    ref = ref_build(rcfg)
    max_len = 28 + rcfg.n_patches
    prefill = jax.jit(ref_steps.make_prefill_step(ref, max_len))
    step = jax.jit(ref_steps.make_serve_step(ref))
    tok, cache = prefill(params, ref_batch(rcfg, 2, 20, seed=0))
    out = [tok]
    for _ in range(7):
        tok, cache = step(params, cache, tok)
        out.append(tok)
    assert np.array_equal(ids.numpy(), np.concatenate(out, 1))


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_example_matches_reference_example(monkeypatch, capsys):
    """``examples/serve_personalized_torch.py --arch qwen2-vl-2b`` with the
    reference example's weights prints the reference example's requests
    (its max_len counts the patches)."""
    monkeypatch.setattr(sys, "argv", ["serve_personalized.py", "--arch",
                                      ARCH])
    _load_example("serve_personalized").main()
    want = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("request")]
    rcfg = ref_config(ARCH).reduced()
    params = ref_build(rcfg).init(jax.random.PRNGKey(0))
    state = convert.lm_state_from_reference(
        jax.tree_util.tree_map(np.asarray, params), rcfg)
    assert "projector" in state
    ids = _load_example("serve_personalized_torch").main(
        ["--device", "cpu", "--arch", ARCH], params=state)
    got = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("request")]
    assert tuple(ids.shape) == (4, 24)
    assert got == want and len(got) == 4
