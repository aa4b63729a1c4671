"""The port's flash decode and decode attention against the JAX package's.

The JAX side is ``repro``'s ``flash_decode`` (the Pallas kernel, in
interpret mode on the CPU), its oracle ``flash_decode_ref`` and
``models.attention.decode_attention`` with ``use_pallas`` False and True;
the port side is the plain masked softmax behind ``ops.flash_decode`` on
CPU tensors. Inputs come from numpy with a fixed seed and are cast to
bf16 the same way (round to nearest even) in both packages. Tolerances
are the reference's own (``tests/test_kernels.py``): fp32 at 1e-5, bf16
at 3e-2 (the output is rounded to bf16, and the Pallas kernel sums in
512-key blocks), the sliding window at atol 1e-5 / rtol 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels.flash_decode.ops import flash_decode as pallas_decode
from repro.kernels.flash_decode.ref import flash_decode_ref as oracle
from repro.models import attention as RA
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_decode import ops
from repro_torch.kernels.flash_decode.ref import (flash_decode_ref,
                                                  flash_decode_split_ref)
from repro_torch.models import attention as TA
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# The CUDA kernel against its plain version on the card, as (atol, rtol):
# both sum in fp32 and round once to the output's type, so bf16 outputs
# differ by at most one ulp (chip_smoke.py's FLASH_TOL).
CARD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-3, 1e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(b, h, kv, hd, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("s", [256, 1024, 1000])
@pytest.mark.parametrize("h,kv,hd", [(8, 2, 64), (4, 4, 128), (7, 1, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_matches_pallas_kernel_and_oracle(s, h, kv, hd, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, h, kv, hd, s, s + h), dtype)
    lengths = np.array([s, max(1, s // 3)], np.int32)
    got = _f32(ops.flash_decode(tq, tk, tv, torch.from_numpy(lengths)))
    tol = DTYPES[dtype][2]
    for want in (pallas_decode(jq, jk, jv, lengths),
                 oracle(jq, jk, jv, jnp.asarray(lengths))):
        np.testing.assert_allclose(got, _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [128, 512, 4096])
def test_flash_decode_sliding_window(window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 4, 2, 64, 2048, 7),
                                       "float32")
    lengths = np.array([2048, 1500], np.int32)
    got = ops.flash_decode(tq, tk, tv, torch.from_numpy(lengths),
                           window=window).numpy()
    for want in (pallas_decode(jq, jk, jv, lengths, window=window),
                 oracle(jq, jk, jv, jnp.asarray(lengths), window=window)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=1e-4)


def test_flash_decode_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 1, 16, 32, 0))
    length = torch.tensor([32, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="length"):
        ops.flash_decode(q, k, v, length.long())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_decode(q.double(), k.double(), v.double(), length)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_decode(q[..., :12], k[..., :12].contiguous(),
                         v[..., :12].contiguous(), length)
    with pytest.raises(ValueError, match="H/K"):
        ops.flash_decode(torch.zeros(2, 17, 16), torch.zeros(2, 32, 1, 16),
                         torch.zeros(2, 32, 1, 16), length)
    with pytest.raises(ValueError, match="window"):
        ops.flash_decode(q, k, v, length, window=0)


def _attn_pair(kind):
    rcfg = ref_config("recurrentgemma-9b").reduced()
    cfg = get_config("recurrentgemma-9b").reduced()
    params = jax.tree_util.tree_map(
        np.asarray, RA.attn_init(jax.random.PRNGKey(3), rcfg))
    mod = TA.Attention(cfg)
    convert.load_reference(mod, params)
    return rcfg, cfg, params, mod


@pytest.mark.parametrize("start", ["empty", "prefill"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("kind", ["local", "attn"])
def test_decode_attention_matches_reference(kind, use_pallas, start):
    """Decode past the window: a local layer's ring (64 slots) wraps, from
    an empty cache at step 64 and from a 70-token prefill at once; a
    global layer fills its cache in order. Outputs and caches are compared
    at every step."""
    rcfg, cfg, params, mod = _attn_pair(kind)
    rng = np.random.default_rng(11)
    d, b, max_len = cfg.d_model, 2, 96
    t0 = 70 if start == "prefill" else 0
    steps = 80 if start == "empty" else 16
    cache_r = RA.init_kv_cache(rcfg, b, max_len, kind)
    cache_p = TA.init_kv_cache(cfg, b, max_len, kind)
    with torch.no_grad():
        if t0:
            x = rng.standard_normal((b, t0, d)).astype(np.float32)
            pos = np.broadcast_to(np.arange(t0), (b, t0))
            out_r, cache_r = RA.prefill_attention(params, x, pos, cache_r,
                                                  rcfg, kind=kind)
            out_p, cache_p = TA.prefill_attention(
                mod, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                cache_p, cfg, kind=kind)
            np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r),
                                       atol=1e-5, rtol=1e-4)
        step = jax.jit(functools.partial(RA.decode_attention, cfg=rcfg,
                                         kind=kind, use_pallas=use_pallas))
        for _ in range(steps):
            x = rng.standard_normal((b, 1, d)).astype(np.float32)
            out_r, cache_r = step(params, x, cache_r)
            out_p, cache_p = TA.decode_attention(mod, torch.from_numpy(x),
                                                 cache_p, cfg, kind=kind)
            np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r),
                                       atol=1e-5, rtol=1e-4)
    assert cache_p.length == int(cache_r.length) == t0 + steps
    np.testing.assert_allclose(cache_p.k.numpy(), np.asarray(cache_r.k),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(cache_p.v.numpy(), np.asarray(cache_r.v),
                               atol=1e-5, rtol=1e-4)


# Split reference cases: (B, H, K, hd, S, lengths, window). S = 256 is one
# Pallas block, so the Pallas kernel pads nothing and takes length > S and
# length 0 as the kernel does.
SPLIT_CASES = {
    "all_masked_chunks": (2, 4, 2, 32, 256, [256, 200], 24),
    "length_0": (2, 4, 1, 32, 256, [0, 130], None),
    "length_past_s": (2, 4, 2, 32, 256, [300, 257], None),
    "window": (2, 8, 2, 64, 256, [256, 100], 70),
    "group_1": (3, 2, 2, 32, 256, [256, 17, 1], None),
    "group_7": (2, 7, 1, 40, 256, [256, 129], None),
    "group_16": (2, 16, 1, 32, 256, [255, 64], 40),
    "hd_24": (2, 4, 1, 24, 256, [256, 99], None),
    "hd_48": (2, 4, 2, 48, 256, [200, 256], 150),
    "hd_56": (2, 8, 1, 56, 256, [256, 3], None),
}


@functools.lru_cache(maxsize=None)
def _split_case(name):
    """Inputs of one case, the port's full softmax and the Pallas kernel's
    output (fp32)."""
    b, h, kv, hd, s, lengths, window = SPLIT_CASES[name]
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, h, kv, hd, s, seed=hd + s),
                                       "float32")
    length = np.array(lengths, np.int32)
    pallas = np.asarray(pallas_decode(jq, jk, jv, length, window=window))
    full = flash_decode_ref(tq, tk, tv, torch.from_numpy(length),
                            window=window).numpy()
    return (tq, tk, tv, torch.from_numpy(length), window), full, pallas


@pytest.mark.parametrize("split", [16, 32, 64, 128, "S"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_ref_matches_full_softmax_and_pallas(case, split):
    """The kernel's split-then-combine arithmetic at any split equals the
    full masked softmax (1e-6) and the Pallas kernel (1e-5): masked
    chunks, an all-masked row (mean of V), length past S, windows and
    G ∈ {1, 7, 16}."""
    (q, k, v, length, window), full, pallas = _split_case(case)
    got = flash_decode_split_ref(
        q, k, v, length, window=window,
        split=k.shape[1] if split == "S" else split).numpy()
    np.testing.assert_allclose(got, full, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)


def test_split_ref_all_masked_row_is_mean_of_v():
    (q, k, v, length, window), _, _ = _split_case("length_0")
    got = flash_decode_split_ref(q, k, v, length, window=window, split=32)
    mean = v[0].mean(dim=0).repeat_interleave(q.shape[1] // k.shape[2], 0)
    torch.testing.assert_close(got[0], mean, atol=1e-6, rtol=1e-6)


# Card cases: (B, H, K, hd, S, lengths, window). The serving shape with a
# short row and a one-key row; G < 16 (rows of the mma's A operand left
# zero) and hd % 16 == 8 (a half k-step); a window whose rows leave whole
# chunks without a valid key; a row with no valid key (mean of V) and one
# past S; every remainder of hd mod 32 after the mma's 32-dimension steps
# (24 and 56: a whole 16-dimension step and a half one; 48: one whole).
CARD_CASES = [
    (4, 16, 1, 256, 2048, [2048, 2041, 1000, 1], None),
    (2, 7, 1, 32, 1000, [1000, 611], 300),
    (2, 7, 1, 40, 333, [333, 0], None),
    (3, 8, 2, 64, 129, [129, 64, 400], None),
    (2, 1, 1, 128, 700, [700, 450], 37),
    (2, 16, 1, 56, 500, [500, 77], None),
    (2, 8, 2, 48, 300, [300, 129], 100),
    (2, 4, 1, 24, 200, [200, 65], None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CARD_CASES)))
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, case):
    """The kernel launches and agrees with the plain masked softmax and
    with the split reference at the source's keys per block."""
    b, h, kv, hd, s, lengths, window = CARD_CASES[case]
    tdt = DTYPES[dtype][1]
    atol, rtol = CARD_TOL[dtype]
    q, k, v = (torch.from_numpy(a).to(cuda_device, tdt)
               for a in _qkv(b, h, kv, hd, s, seed=s))
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = ops.flash_decode.launches
    got = ops.flash_decode(q, k, v, length, window=window)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    for want in (flash_decode_ref(q, k, v, length, window=window),
                 flash_decode_split_ref(q, k, v, length, window=window,
                                        split=ops.keys_per_block())):
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
