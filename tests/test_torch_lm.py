"""The port's RecurrentGemma LM and serving path against the JAX package's.

Both packages run ``recurrentgemma-9b``'s ``reduced()`` config (fp32,
d = 256, window 64, 19 layers) or a 6-layer cut of it (pattern
(rglru, rglru, local) repeated twice, which exercises the repeat-major
layer order), with the reference's params carried over by
``convert.lm_state_from_reference``. Logits agree at atol 5e-5 /
rtol 1e-4: the same fp32 math, with matmuls summed in another order and
the recurrence as a sequential loop against the reference's associative
scan (measured differences stay below 1e-5 on logits of magnitude ~5).
Greedy ids must be equal.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import steps as ref_steps
from repro.models.registry import build_model as ref_build
from repro.models.registry import random_batch as ref_batch
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.registry import build_model, random_batch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=5e-5, rtol=1e-4)
ARCH = "recurrentgemma-9b"
CUT = dict(layer_pattern=("rglru", "rglru", "local"), n_layers=6)


def _configs(cut: bool):
    rcfg, cfg = ref_config(ARCH).reduced(), get_config(ARCH).reduced()
    if cut:
        rcfg = dataclasses.replace(rcfg, **CUT)
        cfg = dataclasses.replace(cfg, **CUT)
    return rcfg, cfg


def _pair(cut: bool, seed: int = 0):
    """Reference model and params, and the port's LM holding them."""
    rcfg, cfg = _configs(cut)
    ref = ref_build(rcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    ref.init(jax.random.PRNGKey(seed)))
    port = build_model(cfg, device="cpu")
    convert.load_lm_reference(port, params)
    return rcfg, cfg, ref, params, port


def lm_state_to_reference(state, cfg) -> dict:
    """The port ``LM``'s ``state_dict`` → reference ``LM`` params (numpy
    leaves; bfloat16 comes back as float32, which holds it exactly)."""
    def exact(t: torch.Tensor) -> torch.Tensor:
        return t.float() if t.dtype == torch.bfloat16 else t

    g, reps = len(cfg.layer_pattern), cfg.pattern_repeats
    layers = []
    for gi in range(g):
        paths = [n.split(".", 2)[2] for n in state
                 if n.startswith(f"layers.{gi}.")]
        layers.append(convert.state_to_reference({
            path: exact(torch.stack([state[f"layers.{r * g + gi}.{path}"]
                                     for r in range(reps)]))
            for path in paths}))
    return {**convert.state_to_reference({
        n: exact(t) for n, t in state.items()
        if not n.startswith("layers.")}), "layers": tuple(layers)}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_param_count_matches_reference():
    """The analytic count (a copy of the reference's, which counts norm2
    twice and leaves out λ and the final norm) and the count of the
    parameters each package builds."""
    full = get_config(ARCH)
    assert full.param_count() == ref_config(ARCH).param_count() \
        == 7_483_686_912
    for cut in (False, True):
        rcfg, cfg = _configs(cut)
        assert cfg.param_count() == rcfg.param_count()
        shapes = jax.eval_shape(ref_build(rcfg).init, jax.random.PRNGKey(0))
        ref_total = sum(x.size for x in jax.tree_util.tree_leaves(shapes))
        port = build_model(cfg, device="cpu")
        assert sum(p.numel() for p in port.parameters()) == ref_total


@pytest.mark.parametrize("cut", [False, True])
def test_apply_logits_match_reference(cut):
    rcfg, cfg, ref, params, port = _pair(cut)
    batch = ref_batch(rcfg, 2, 100, seed=3)
    want = ref.apply(params, batch)
    with torch.no_grad():
        got = port.apply(random_batch(cfg, 2, 100, seed=3, device="cpu"))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("prompt", [40, 100])
def test_prefill_logits_and_caches_match_reference(prompt):
    """A prompt shorter and one longer than the 64-token window: the local
    layers' rings, the RG-LRU states and the logits as the reference's."""
    rcfg, cfg, ref, params, port = _pair(cut=True)
    tokens = ref_batch(rcfg, 2, prompt, seed=4)["tokens"]
    logits_r, cache_r = ref.prefill(params, {"tokens": tokens}, 200)
    logits_p, cache_p = port.prefill(
        {"tokens": torch.tensor(np.asarray(tokens))}, 200)
    np.testing.assert_allclose(_np(logits_p), _np(logits_r), **TOL)
    assert cache_p["step"] == int(cache_r["step"]) == prompt
    g = len(cfg.layer_pattern)
    for layer, got in enumerate(cache_p["layers"]):
        want = cache_r["groups"][layer % g]
        for field in got._fields:
            if field == "length":
                assert got.length == prompt == int(want.length[layer // g])
                continue
            np.testing.assert_allclose(
                _np(getattr(got, field)),
                _np(getattr(want, field))[layer // g], **TOL)


def _ref_greedy(ref, params, tokens, gen, max_len):
    """The reference's greedy loop (as its serve.py), keeping logits."""
    logits, cache = jax.jit(
        lambda p, b: ref.prefill(p, b, max_len))(params, {"tokens": tokens})
    logits = [np.asarray(logits[:, -1])]
    step = jax.jit(ref.decode_step)
    ids = [logits[0].argmax(-1)[:, None].astype(np.int32)]
    for _ in range(gen - 1):
        lg, cache = step(params, cache, ids[-1])
        logits.append(np.asarray(lg))
        ids.append(logits[-1].argmax(-1)[:, None].astype(np.int32))
    return np.concatenate(ids, 1), np.stack(logits, 1)


def test_greedy_decode_matches_reference_past_the_window():
    """2 × window decode steps after a 20-token prompt: the local rings
    wrap at step 44; logits at TOL and greedy ids exactly equal."""
    rcfg, cfg, ref, params, port = _pair(cut=True)
    tokens = ref_batch(rcfg, 2, 20, seed=5)["tokens"]
    gen = 2 * cfg.window
    ids_r, logits_r = _ref_greedy(ref, params, tokens, gen, 20 + gen)
    steps = serve.generate(port,
                           {"tokens": torch.tensor(np.asarray(tokens))},
                           gen, 20 + gen)
    ids_p, logits_p = zip(*steps)
    np.testing.assert_allclose(torch.stack(logits_p, 1).numpy(), logits_r,
                               **TOL)
    assert np.array_equal(torch.cat(ids_p, 1).numpy(), ids_r)


@pytest.mark.parametrize("arch", [ARCH, "xlstm-350m"])
def test_serve_main_matches_reference_loop(capsys, arch):
    """``serve.main`` on the CPU: the port's seeded weights, carried back
    to the reference, give the same ids through the reference's own
    prefill and serve steps."""
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "20", "--gen", "8", "--device", "cpu", "--seed", "0"]
    ids = serve.main(argv)
    assert "tok/s" in capsys.readouterr().out
    assert tuple(ids.shape) == (2, 8)
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    port = serve.load_model(arch, reduced=True, device="cpu", seed=0)
    params = lm_state_to_reference(port.state_dict(), cfg)
    ref = ref_build(rcfg)
    prefill = jax.jit(ref_steps.make_prefill_step(ref, 28))
    step = jax.jit(ref_steps.make_serve_step(ref))
    tok, cache = prefill(params, ref_batch(rcfg, 2, 20, seed=0))
    out = [tok]
    for _ in range(7):
        tok, cache = step(params, cache, tok)
        out.append(tok)
    assert np.array_equal(ids.numpy(), np.concatenate(out, 1))


def test_decode_matches_teacher_forced_apply():
    """Inside the port: prefill 20 tokens, then feed the next 2 × window
    tokens one at a time; each step's logits equal ``apply`` over the
    whole sequence at that position, before and after the rings wrap."""
    _, cfg, _, _, port = _pair(cut=True, seed=1)
    total = 20 + 2 * cfg.window
    tokens = random_batch(cfg, 2, total, seed=6, device="cpu")["tokens"]
    with torch.no_grad():
        full = port.apply({"tokens": tokens})
        logits, cache = port.prefill({"tokens": tokens[:, :20]}, total)
        torch.testing.assert_close(logits, full[:, :20], **TOL)
        for t in range(20, total):
            lg, cache = port.decode_step(cache, tokens[:, t:t + 1])
            torch.testing.assert_close(lg, full[:, t], **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_params_round_trip(dtype):
    """Reference params → port LM → reference params, exactly; bf16
    leaves stay bf16 in the port (λ stays fp32) and come back as fp32."""
    rcfg, cfg = (dataclasses.replace(c, dtype=dtype)
                 for c in _configs(cut=True))
    params = jax.tree_util.tree_map(
        np.asarray, ref_build(rcfg).init(jax.random.PRNGKey(0)))
    port = build_model(cfg, device="cpu")
    convert.load_lm_reference(port, params)
    assert port.embed.dtype == getattr(torch, dtype)
    assert port.layers[0].mix.lam.dtype == torch.float32
    back = lm_state_to_reference(port.state_dict(), cfg)
    same = jax.tree_util.tree_map(
        lambda a, b: np.array_equal(a.astype(np.float32), b), params, back)
    assert jax.tree_util.tree_all(same)
    bad = dict(params, embed=params["embed"][:, :8])
    with pytest.raises(ValueError, match="embed"):
        convert.load_lm_reference(port, bad)


def test_registry_and_batches():
    rcfg, cfg = _configs(cut=False)
    for kind, seq in (("train", 12), ("decode", 12)):
        want = ref_batch(rcfg, 3, seq, seed=9, kind=kind)["tokens"]
        got = random_batch(cfg, 3, seq, seed=9, kind=kind,
                           device="cpu")["tokens"]
        assert np.array_equal(got.numpy(), np.asarray(want))
    # the stub frontends' inputs come after the tokens, from the same rng
    for arch, stub in (("whisper-large-v3", "frames"),
                       ("qwen2-vl-2b", "patches")):
        rc, c = ref_config(arch).reduced(), get_config(arch).reduced()
        want = ref_batch(rc, 3, 12, seed=9)
        got = random_batch(c, 3, 12, seed=9, device="cpu")
        assert set(got) == set(want) == {"tokens", stub}
        for k in want:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    mrope = build_model(dataclasses.replace(cfg, rope="mrope"), device="cpu")
    assert mrope.cfg.rope == "mrope"
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("whisper-large-v4")


def test_serve_entry_points_without_device_need_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _configs(cut=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", ARCH, "--reduced", "--gen", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_batch(cfg, 2, 8)
