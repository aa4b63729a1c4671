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
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.models import attention as TA

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,hd,s,window", [
    (4, 16, 1, 256, 2048, None), (2, 7, 1, 32, 1000, 300),
    (3, 8, 2, 64, 129, None)])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, b, h, kv,
                                              hd, s, window):
    tdt = DTYPES[dtype][1]
    atol, rtol = CARD_TOL[dtype]
    q, k, v = (torch.from_numpy(a).to(cuda_device, tdt)
               for a in _qkv(b, h, kv, hd, s, seed=s))
    length = torch.tensor([s, s // 2, 1, s + 5][:b], dtype=torch.int32,
                          device=cuda_device)
    before = ops.flash_decode.launches
    got = ops.flash_decode(q, k, v, length, window=window)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    want = flash_decode_ref(q, k, v, length, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
