"""The port's encoder-decoder (``models/whisper.py``, whisper-large-v3)
against the JAX package's.

Both packages run whisper-large-v3's ``reduced()`` config (fp32, d = 256,
2 encoder and 2 decoder layers, 32 stub frames; ``reduced()`` makes the
MHA 4 query heads over 2 KV heads, so the decode cases add
``n_kv_heads = n_heads`` for G = 1) with the reference's params carried
over by ``convert.load_encdec_reference``. The encoder output agrees at
1e-5 (the same fp32 math summed in other orders; it reads ≤ 2e-6 on
values of order one after the final norm), logits at ``test_torch_lm``'s
TOL, decode logits at the reference's own decode-vs-forward tolerance
(atol 2e-3, rtol 1e-3, ``tests/test_models_consistency.py``), greedy
ids exactly, on both cross-attention paths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_pytree as ref_save
from repro.configs import get_config as ref_config
from repro.core.rwsadmm import RWSADMMHparams as RHP
from repro.launch import serve as ref_serve
from repro.launch import steps as ref_steps
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models.registry import build_model as ref_build
from repro.models.registry import random_batch as ref_batch
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.launch import serve, steps
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models.registry import build_model, random_batch
from repro_torch.models.whisper import EncDecLM
from test_torch_lm import TOL
from test_torch_train_step import MAX_FLIP_SHARE, STEP_TOL, _tie
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "whisper-large-v3"
#: the reference's decode-vs-forward tolerance
DECODE_TOL = dict(atol=2e-3, rtol=1e-3)
ENC_TOL = dict(atol=1e-5, rtol=1e-5)
#: the reference's count at full width (its formula, as the port's), and
#: the parameters both packages build: the formula counts 4·d of norms
#: an encoder layer and 6·d a decoder layer, where they hold 2·d and
#: 3·d, and leaves out the final and the encoder's norms (158·d more)
FULL_COUNT = 1_576_747_520
FULL_BUILT = 1_576_545_280


def _configs(kv=None):
    rcfg, cfg = ref_config(ARCH).reduced(), get_config(ARCH).reduced()
    if kv is not None:
        rcfg = dataclasses.replace(rcfg, n_kv_heads=kv)
        cfg = dataclasses.replace(cfg, n_kv_heads=kv)
    return rcfg, cfg


def _pair(kv=None, seed=0):
    """Reference model and params, and the port's EncDecLM holding them."""
    rcfg, cfg = _configs(kv)
    ref = ref_build(rcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    ref.init(jax.random.PRNGKey(seed)))
    port = build_model(cfg, device="cpu")
    convert.load_encdec_reference(port, params)
    return rcfg, cfg, ref, params, port


def _to_torch(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def _as_reference(model):
    return jax.tree_util.tree_map(lambda t: t.float().numpy(),
                                  convert.reference_tree(model))


def test_param_count_matches_reference():
    full_r, full = ref_config(ARCH), get_config(ARCH)
    assert full.param_count() == full_r.param_count() == FULL_COUNT
    shapes = jax.eval_shape(ref_build(full_r).init, jax.random.PRNGKey(0))
    assert sum(x.size for x in jax.tree_util.tree_leaves(shapes)) \
        == FULL_BUILT
    assert sum(p.numel() for p in EncDecLM(full, device="meta")
               .parameters()) == FULL_BUILT
    rcfg, cfg = _configs()
    assert cfg.param_count() == rcfg.param_count()
    shapes = jax.eval_shape(ref_build(rcfg).init, jax.random.PRNGKey(0))
    port = build_model(cfg, device="cpu")
    assert isinstance(port, EncDecLM)
    assert sum(p.numel() for p in port.parameters()) == sum(
        x.size for x in jax.tree_util.tree_leaves(shapes))


@pytest.mark.parametrize("seq,d", [(1500, 1280), (32, 256), (7, 10)])
def test_sinusoidal_positions_bit_for_bit(seq, d):
    got = layers.sinusoidal_positions(seq, d)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(),
                          np.asarray(ref_layers.sinusoidal_positions(seq, d)))


def test_random_batch_frames_match_reference():
    rcfg, cfg = _configs()
    for dtype in ("float32", "bfloat16"):
        want = ref_batch(dataclasses.replace(rcfg, dtype=dtype), 2, 12,
                         seed=5)
        got = random_batch(dataclasses.replace(cfg, dtype=dtype), 2, 12,
                           seed=5, device="cpu")
        assert set(got) == set(want) == {"tokens", "frames"}
        assert got["frames"].dtype == getattr(torch, dtype)
        for k in want:
            assert np.array_equal(got[k].float().numpy(),
                                  np.asarray(want[k]).astype(np.float32))


def test_encode_apply_and_loss_match_reference():
    rcfg, cfg, ref, params, port = _pair()
    batch = ref_batch(rcfg, 2, 20, seed=3)
    with torch.no_grad():
        enc = port.encode(torch.as_tensor(np.array(batch["frames"])))
        logits = port.apply(_to_torch(batch))
        loss = port.loss(_to_torch(batch))
    np.testing.assert_allclose(
        enc.numpy(), np.asarray(ref.encode(params, batch["frames"])),
        **ENC_TOL)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(ref.apply(params, batch)), **TOL)
    np.testing.assert_allclose(float(loss), float(ref.loss(params, batch)),
                               rtol=1e-6)


def _ref_greedy(ref, params, batch, gen, max_len, project):
    """The reference's encode-then-decode loop (its serve.py's, or with
    the projected cross K/V), keeping logits."""
    enc = jax.jit(ref.encode)(params, batch["frames"])
    cache = ref.init_cache(batch["tokens"].shape[0], max_len, enc_out=enc,
                           params=params if project else None)
    step = jax.jit(ref.decode_step)
    ids, logits = [np.asarray(batch["tokens"][:, :1])], []
    for _ in range(gen):
        lg, cache = step(params, cache, ids[-1])
        logits.append(np.asarray(lg))
        ids.append(logits[-1].argmax(-1)[:, None].astype(np.int32))
    return np.concatenate(ids, 1), np.stack(logits, 1)


@pytest.mark.parametrize("kv", [None, 4])
@pytest.mark.parametrize("project", [False, True])
def test_greedy_decode_matches_reference(project, kv):
    """12 greedy steps on both cross-attention paths, at G = 2 (reduced)
    and G = 1 (n_kv_heads = n_heads): logits at the reference's decode
    tolerance, ids exactly; the projected cache holds each layer's cross
    K/V at the reference's."""
    rcfg, cfg, ref, params, port = _pair(kv)
    batch = ref_batch(rcfg, 2, 4, seed=4)
    gen, max_len = 12, 16
    ids_r, logits_r = _ref_greedy(ref, params, batch, gen, max_len, project)
    tb = _to_torch(batch)
    with torch.no_grad():
        enc = port.encode(tb["frames"])
    ids_p, logits_p = zip(*serve.generate_encdec(
        port, enc, tb["tokens"][:, :1], gen, max_len, project=project))
    np.testing.assert_allclose(torch.stack(logits_p, 1).numpy(), logits_r,
                               **DECODE_TOL)
    assert np.array_equal(
        torch.cat([tb["tokens"][:, :1], *ids_p], 1).numpy(), ids_r)
    if project:
        cache = port.init_cache(2, max_len, enc, project=True)
        want = ref.init_cache(2, max_len, enc_out=jnp.asarray(enc.numpy()),
                              params=params)["cross_kv"]
        for l, (k, v) in enumerate(cache["cross_kv"]):
            np.testing.assert_allclose(k.numpy(), np.asarray(want["k"][l]),
                                       **TOL)
            np.testing.assert_allclose(v.numpy(), np.asarray(want["v"][l]),
                                       **TOL)


def test_decode_matches_teacher_forced_apply():
    """Inside the port, on both paths: each decode step's logits equal
    ``apply`` over the whole sequence at that position."""
    _, cfg, _, _, port = _pair(seed=1)
    batch = random_batch(cfg, 2, 10, seed=6, device="cpu")
    with torch.no_grad():
        full = port.apply(batch)
        enc = port.encode(batch["frames"])
        for project in (False, True):
            cache = port.init_cache(2, 16, enc, project=project)
            for t in range(10):
                lg, cache = port.decode_step(cache,
                                             batch["tokens"][:, t:t + 1])
                torch.testing.assert_close(lg, full[:, t], **DECODE_TOL)


def _reference_cross_attn(q, k, v, hd):
    """The reference's cached ``cross_attn`` contraction
    (``src/repro/models/whisper.py``): fp32 scores over all T frames, an
    unmasked softmax, P·V."""
    b, nh, _ = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, kvh, nh // kvh, hd)
    scores = jnp.einsum("bkgh,btkh->bkgt", qg.astype(jnp.float32),
                        k.astype(jnp.float32)) / np.sqrt(hd)
    w = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum("bkgt,btkh->bkgh", w, v.astype(jnp.float32))
    return out.reshape(b, nh, hd)


@pytest.mark.parametrize("dtype,tol", [("float32", ENC_TOL),
                                       ("bfloat16",
                                        dict(atol=2e-2, rtol=3e-2))])
@pytest.mark.parametrize("h,kv", [(4, 2), (4, 4), (20, 20)])
def test_cross_decode_matches_reference_cross_attn(h, kv, dtype, tol):
    """The cached cross-attention's plain version (the flash-decode
    kernel's, with every length T) against the reference's einsum, and
    the whole layer against the reference's recompute path
    (``attention(x_kv=enc, causal=False)``) for one query; G = 2 and G =
    1, whisper's H = K = 20 among them."""
    hd, t, b = 64, 150, 3
    rng = np.random.default_rng(h + kv)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in (q, k, v))
    got = flash_decode(tq, tk, tv, torch.full((b,), t, dtype=torch.int32))
    want = _reference_cross_attn(*(jnp.asarray(a, jnp.dtype(dtype))
                                   for a in (q, k, v)), hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)

    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_heads=h,
                              n_kv_heads=kv, head_dim=hd, d_model=128)
    rcfg = dataclasses.replace(ref_config(ARCH).reduced(), n_heads=h,
                               n_kv_heads=kv, head_dim=hd, d_model=128)
    rp = jax.tree_util.tree_map(np.asarray, ref_attn.attn_init(
        jax.random.PRNGKey(h), rcfg))
    mod = attn_mod.Attention(cfg, device="cpu")
    convert.load_reference(mod, rp)
    x = rng.normal(size=(b, 1, 128)).astype(np.float32)
    enc = rng.normal(size=(b, t, 128)).astype(np.float32)
    want = ref_attn.attention(rp, jnp.asarray(x), jnp.zeros((b, 1), int),
                              rcfg, x_kv=jnp.asarray(enc), causal=False)
    with torch.no_grad():
        te = torch.as_tensor(enc)
        cached = attn_mod.cross_decode_attention(
            mod, torch.as_tensor(x), *attn_mod.cross_kv(mod, te, cfg), cfg)
        recomputed = attn_mod.attention(
            mod, torch.as_tensor(x), torch.zeros(b, 1, dtype=torch.int64),
            cfg, x_kv=te, causal=False)
    for out in (cached, recomputed):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_train_step_matches_reference():
    """One ``make_train_step`` step of the EncDecLM from the reference's
    init: loss, κ and x, z, y at ``test_torch_train_step``'s STEP_TOL,
    y's sign flips at ties left out."""
    hp = dict(beta=2.0, kappa=0.05, epsilon=1e-3)
    rcfg, cfg, ref, params, port = _pair()
    batch = ref_batch(rcfg, 2, 24, seed=10)
    r_st = ref_steps.init_train_state(params, RHP(**hp))
    r_next, r_loss = jax.jit(ref_steps.make_train_step(ref, RHP(**hp), 8))(
        r_st, batch)
    state = convert.encdec_state_from_reference(params)
    st, loss = steps.make_train_step(port, RWSADMMHparams(**hp), 8)(
        steps.init_train_state(state, RWSADMMHparams(**hp)),
        _to_torch(batch))
    np.testing.assert_allclose(float(loss), float(r_loss), **STEP_TOL)
    np.testing.assert_allclose(float(st.kappa), float(r_next.kappa),
                               rtol=1e-7)

    def as_port(tree):
        return convert.encdec_state_from_reference(
            jax.tree_util.tree_map(np.asarray, tree))

    y0, rx = as_port(r_st.y), as_port(r_next.x)
    moved = 0
    for name in ("x", "z", "y"):
        want, got = as_port(getattr(r_next, name)), getattr(st, name)
        assert set(got) == set(want) == set(state)
        for leaf, w in want.items():
            keep = torch.ones_like(w, dtype=torch.bool)
            if name == "y":     # sgn(y' − x) may differ at a tie
                gap = y0[leaf] - rx[leaf]
                flip = torch.sign(gap) != torch.sign(y0[leaf] - st.x[leaf])
                assert bool((gap.abs()[flip] <= _tie(y0[leaf])[flip]).all())
                assert int(flip.sum()) <= MAX_FLIP_SHARE * flip.numel() + 1
                keep = ~flip
            np.testing.assert_allclose(got[leaf][keep].numpy(),
                                       w[keep].numpy(), **STEP_TOL,
                                       err_msg=f"{name} {leaf}")
            moved += int(name == "x" and not torch.equal(got[leaf],
                                                         state[leaf]))
    assert moved > 0


def test_serve_main_matches_reference_loop(capsys):
    """``serve.main`` on the CPU: encode, then 8 decode steps from each
    row's first token; the port's seeded weights, carried back to the
    reference, give the same ids through the reference's own steps."""
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "20", "--gen", "8", "--device", "cpu", "--seed", "0"]
    ids = serve.main(argv)
    out = capsys.readouterr().out
    assert "encode: 2×32 frames" in out and "tok/s" in out
    assert tuple(ids.shape) == (2, 9)
    rcfg, _ = _configs()
    port = serve.load_model(ARCH, reduced=True, device="cpu", seed=0)
    ids_r, _ = _ref_greedy(ref_build(rcfg), _as_reference(port),
                           ref_batch(rcfg, 2, 20, seed=0), 8, 28,
                           project=False)
    assert np.array_equal(ids.numpy(), ids_r)


@pytest.mark.parametrize("arch", [ARCH, "qwen2-vl-2b"])
def test_serve_loads_reference_checkpoint(tmp_path, capsys, arch):
    """A checkpoint the reference writes of its params (its
    ``save_pytree``) serves through ``serve.main --ckpt`` the ids the
    reference's own ``serve.main --ckpt`` serves."""
    rcfg = ref_config(arch).reduced()
    path = str(tmp_path / "params.npz")
    ref_save(path, ref_build(rcfg).init(jax.random.PRNGKey(3)))
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "12", "--gen", "6", "--ckpt", path]
    ref_serve.main(argv)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("sample token ids")]
    ids = serve.main(argv + ["--device", "cpu", "--seed", "0"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("sample token ids")]
    assert got == want and len(got) == 1
    assert ids.shape[0] == 2
    params = convert.reference_tree(serve.load_model(
        arch, reduced=True, device="cpu", ckpt=path))
    seeded = convert.reference_tree(serve.load_model(
        arch, reduced=True, device="cpu", seed=3))
    assert not torch.equal(params["embed"], seeded["embed"])


def test_train_step_takes_either_ce_impl():
    """The EncDecLM's loss takes no ``ce_impl``: the step runs with
    either value, as the reference's does, and gives the same loss."""
    _, cfg, _, params, port = _pair()
    state = convert.encdec_state_from_reference(params)
    batch = random_batch(cfg, 2, 8, seed=2, device="cpu")
    hp = RWSADMMHparams(beta=2.0, kappa=0.05, epsilon=1e-3)
    losses = [float(steps.make_train_step(port, hp, 4, ce_impl=c)(
        steps.init_train_state(state, hp), batch)[1])
        for c in ("gather", "onehot")]
    assert losses[0] == losses[1]


@pytest.mark.cuda
def test_flash_decode_at_whisper_shapes_on_card():
    """Flash decode at whisper-large-v3's cross-attention (G = 1, hd 64,
    T = 1500 all valid) and decoder self-attention (lengths below S),
    bf16 and fp32, against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tols = {torch.float32: dict(atol=1e-5, rtol=1e-5),
            torch.bfloat16: dict(atol=1e-3, rtol=1e-2)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for s, lengths in ((1500, [1500] * 4), (2056, [2041, 1, 17, 2056])):
        for dt, tol in tols.items():
            q = torch.randn(4, 20, 64, generator=gen, device="cuda").to(dt)
            k, v = (torch.randn(4, s, 20, 64, generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            torch.testing.assert_close(
                flash_decode(q, k, v, length).float(),
                flash_decode_ref(q, k, v, length).float(), **tol)
