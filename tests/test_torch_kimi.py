"""kimi-k2-1t-a32b cut to one layer at full width, the configuration
``chip_smoke.py``'s mesh phase serves on the card, and the draws its
init needs past 2^32 values.

* The cut's parameters: 19,422,663,680 built on ``meta`` (36.2 GiB in
  bf16); ``param_count`` reads 19,422,670,848 in both packages, one
  d_model more (a norm the formula counts that the layer does not hold).
* A leaf of more than 2^32 values (an expert stack, (384, 7168, 2048))
  draws its normals at 64-bit counters, as JAX's partitionable threefry
  does (its ``iota_2x32_shape``: the row-major index as high and low
  words): the bits at counters past 2^32 equal ``threefry2x32_p``'s at
  those words, and ``normal_blocks`` reaches them at their offsets.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax._src import prng as jprng

from repro.configs import get_config as ref_config
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.kernels.threefry import ops
from repro_torch.models.transformer import LM
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "kimi-k2-1t-a32b"
CUT_PARAMS = 19_422_663_680
CUT_PARAM_COUNT = 19_422_670_848


def test_one_layer_cut_at_full_width():
    cfg = dataclasses.replace(get_config(ARCH), n_layers=1)
    model = LM(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == CUT_PARAMS
    assert cfg.param_count() == CUT_PARAM_COUNT
    assert dataclasses.replace(ref_config(ARCH),
                               n_layers=1).param_count() == CUT_PARAM_COUNT
    assert sum(p.numel() * p.element_size()
               for p in model.parameters()) / 2**30 > 36.1


def test_counters_past_two_to_the_32():
    assert jax.config.jax_threefry_partitionable
    key = prng.prng_key(3)
    lo = np.arange(5, 13, dtype=np.uint32)
    for hi in (1, 2):
        want = jprng.threefry2x32_p.bind(
            jnp.uint32(int(key[0])), jnp.uint32(int(key[1])),
            jnp.full(8, hi, jnp.uint32), jnp.asarray(lo))
        want = np.asarray(want[0]) ^ np.asarray(want[1])
        got = ops.threefry_bits(key.reshape(1, 2), 8,
                                offset=hi * 2**32 + 5)[0]
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_normal_blocks_start_each_block_at_its_counter():
    key = prng.prng_key(0)
    shape = (3, 2**31 + 1, 1)
    seen = []
    for r0, r1, rows in prng.normal_blocks(key, shape, block=1):
        seen.append((r0, rows))
        if r0 >= 2:
            break
    # rows are the counters' own draws, whatever block they come in
    for r0, rows in seen:
        bits = ops.threefry_bits(key.reshape(1, 2), 1, offset=r0)
        assert torch.equal(rows.reshape(-1),
                           prng._normal_from_bits(bits).reshape(-1))
