"""A seed's language-model weights in the port are the reference's.

The reference's ``model.init(PRNGKey(seed))`` splits a threefry key tree
and draws ``jax.random.normal`` once a leaf (``LM``: ``split(key, 5)``,
the layers under ``fold_in(split(k_layers, repeats)[r], gi)`` through
``jax.vmap``; ``EncDecLM``: ``split(key, 6)``; each module's ``*_init``
splits its own key). The port's ``init(seed)`` walks the same tree with
``core/prng.py``, whose bits are the reference's and whose normals are
within ``NORMAL_ULP`` ulp of ``jax.random.normal``; a scale is one fp32
product in both packages and a bf16 leaf is that product rounded. So for
every registered config's ``reduced()``:

* fp32 leaves hold the reference's within ``NORMAL_ULP``;
* bf16 leaves (the same configs in bf16) are equal, or one bf16 ulp
  apart where the fp32 products differ;
* ones, zeros and ``full`` leaves are exactly equal.

Nothing is injected: the training driver without ``model=`` prints the
reference's losses within ``LOSS_TOL``, and ``serve.main`` at seed 0
gives the reference serve's greedy ids. ``prng.normal_blocks`` (the
draw a block of rows at a time) equals one whole ``prng.normal`` bit
for bit. The card's init against the CPU's is a ``cuda`` test.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.launch import train as ref_train
from repro.models.registry import build_model as ref_build
from repro_torch import convert
from repro_torch.configs import get_config, list_archs
from repro_torch.core import prng
from repro_torch.launch import serve, train
from repro_torch.models.registry import build_model
from test_torch_privacy import NORMAL_ULP, _ulp_gap
from test_torch_train_launch import LOSS_TOL
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SEEDS = (0, 1)
#: the training driver's run where the seeded weights once parted from
#: the reference's (the same visits 1, 3, 0, other losses), and the
#: losses the reference prints there
TRAIN_ARGV = ["--arch", "tinyllama-1.1b", "--reduced", "--clients", "4",
              "--rounds", "3", "--batch", "2", "--seq", "32"]
TRAIN_LOSSES = (6.6870, 6.7293, 6.3500)
ROUND = re.compile(r"round +\d+  client +(\d+)  loss +(\S+)")
SAMPLE = re.compile(r"sample token ids: (\[.*\])")


def _reference_state(cfg, rcfg, seed):
    """The reference's ``init(PRNGKey(seed))`` under the port's names."""
    params = jax.tree_util.tree_map(
        np.asarray, ref_build(rcfg).init(jax.random.PRNGKey(seed)))
    if cfg.encoder_layers:
        return convert.encdec_state_from_reference(params)
    return convert.lm_state_from_reference(params, cfg)


def _port_state(cfg, seed):
    return build_model(cfg, device="cpu").init(seed).state_dict()


def _constant(t: torch.Tensor) -> bool:
    return bool((t == t.reshape(-1)[0]).all())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("arch", list_archs())
def test_init_follows_the_reference_key_tree(arch, seed):
    cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    got, want = _port_state(cfg, seed), _reference_state(cfg, rcfg, seed)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype == torch.float32, name
        assert g.shape == w.shape, name
        if _constant(w):                      # ones, zeros, full(0.7)
            assert torch.equal(g, w), name
        else:
            assert _ulp_gap(g.numpy(), w.numpy()) <= NORMAL_ULP, name
    # another seed, other weights
    other = _port_state(cfg, seed + 1)
    assert not torch.equal(got["embed"], other["embed"])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "gemma3-12b"])
def test_init_orders_layers_across_repeats(arch):
    """Two repeats of a pattern of several kinds (P > 1 and R > 1, where
    a layer's key ``fold_in(split(k_layers, R)[r], gi)`` and its
    transpose part): flat layer ``r·P + gi`` holds the leaves the
    reference's ``jax.vmap`` over the layer keys gives ``layers[gi][r]``."""
    seed = 0
    cfg, rcfg = (dataclasses.replace(c, n_layers=2 * len(c.layer_pattern))
                 for c in (get_config(arch).reduced(),
                           ref_config(arch).reduced()))
    assert len(cfg.layer_pattern) > 1 and cfg.pattern_repeats == 2
    got, want = _port_state(cfg, seed), _reference_state(cfg, rcfg, seed)
    assert set(got) == set(want)
    for name, w in want.items():
        if _constant(w):
            assert torch.equal(got[name], w), name
        else:
            assert _ulp_gap(got[name].numpy(), w.numpy()) <= NORMAL_ULP, name
    # the repeats' draws differ, so the order above was tested
    p = len(cfg.layer_pattern)
    first = [n for n in want if n.startswith("layers.0.") and "mix" in n]
    assert first and not torch.equal(
        want[first[0]], want[first[0].replace("layers.0.", f"layers.{p}.")])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "kimi-k2-1t-a32b"])
def test_bf16_leaves_round_the_same_products(arch):
    """In bf16 a leaf is the fp32 product rounded: equal to the reference's
    wherever the fp32 products are, else one bf16 ulp apart at most; the
    fp32 leaves (λ, the router) as in fp32."""
    seed = 0
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    rcfg = dataclasses.replace(ref_config(arch).reduced(), dtype="bfloat16")
    got, want = _port_state(cfg, seed), _reference_state(cfg, rcfg, seed)
    got32 = _port_state(get_config(arch).reduced(), seed)
    want32 = _reference_state(get_config(arch).reduced(),
                              ref_config(arch).reduced(), seed)
    assert set(got) == set(want) == set(got32)
    n_bf16 = 0
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype, name
        if w.dtype == torch.float32:
            assert _ulp_gap(g.numpy(), w.numpy()) <= NORMAL_ULP, name
            continue
        n_bf16 += 1
        assert w.dtype == torch.bfloat16, name
        same = got32[name] == want32[name]
        assert torch.equal(g[same], w[same]), name
        gi, wi = (t.view(torch.int16).to(torch.int32) for t in (g, w))
        assert int((gi - wi).abs().max()) <= 1, name
    assert n_bf16 > 0


@pytest.mark.parametrize("shape,block", [((7, 300), 4 * 300),
                                         ((3, 5, 64), 2 * 64 + 1),
                                         ((1000,), 64), ((2, 3), 1)])
def test_normal_blocks_equal_one_draw(shape, block):
    """Rows r0:r1 are the counters from r0·row on: the blocks (a row count
    that the block does not divide, a row longer than the block) put
    together are one ``normal(key, shape)``, bit for bit."""
    key = prng.prng_key(11)
    whole = prng.normal(key, shape).reshape(-1, shape[-1])
    rows = [(r0, r1, draw) for r0, r1, draw
            # repro_torch: allow(prng-key-reuse) -- one draw of the key
            in prng.normal_blocks(key, shape, block)]
    assert rows[0][0] == 0 and rows[-1][1] == whole.shape[0]
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert torch.equal(torch.cat([d for *_, d in rows]), whole)
    assert _ulp_gap(whole.numpy().reshape(shape), np.asarray(
        jax.random.normal(jax.random.PRNGKey(11), shape))) <= NORMAL_ULP


def test_normal_blocks_refuses_what_it_cannot_draw():
    with pytest.raises(ValueError, match="one key"):
        next(prng.normal_blocks(prng.split(prng.prng_key(0), 2), (4, 4)))
    # past 2^32 values the counters' high word carries on (JAX's
    # partitionable iota); past 2^64 there are no counters left
    with pytest.raises(ValueError, match="64-bit"):
        next(prng.normal_blocks(prng.prng_key(0), (2**33, 2**32)))


def test_train_main_prints_the_reference_losses(capsys):
    """The driver without ``model=`` draws seed 0 itself: the reference's
    visits and losses, which it prints at four decimals."""
    ref_train.main(TRAIN_ARGV)
    want = [(int(c), float(loss))
            for c, loss in ROUND.findall(capsys.readouterr().out)]
    visits, losses = train.main([*TRAIN_ARGV, "--device", "cpu"])
    assert visits == [c for c, _ in want] == [1, 3, 0]
    np.testing.assert_allclose(losses, [l for _, l in want], **LOSS_TOL)
    np.testing.assert_allclose(losses, TRAIN_LOSSES, **LOSS_TOL)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b"])
def test_serve_main_gives_the_reference_ids(capsys, arch):
    """``serve.main`` at seed 0 with its own weights: the ids the
    reference's ``serve.main`` prints for row 0."""
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "12", "--gen", "6"]
    ref_serve.main(argv)
    want = SAMPLE.search(capsys.readouterr().out).group(1)
    ids = serve.main([*argv, "--device", "cpu", "--seed", "0"])
    assert tuple(ids.shape) == (2, 6)
    assert ids[0].tolist() == [int(i) for i in want.strip("[]").split(",")]


# -------------------------------------------------------------- card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the threefry kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m",
                                  "kimi-k2-1t-a32b", "whisper-large-v3",
                                  "qwen2-vl-2b"])
def test_card_init_matches_the_cpu(cuda_device, arch):
    """On the card every split, fold-in and block of bits is a
    ``threefry_bits`` launch: the same bits, and erf⁻¹ within
    ``NORMAL_ULP``; constant leaves exactly."""
    from repro_torch.kernels.threefry import ops as tf

    cfg = get_config(arch).reduced()
    before = tf.threefry_bits.launches
    card = build_model(cfg, device=cuda_device).init(3).state_dict()
    torch.cuda.synchronize()
    assert tf.threefry_bits.launches > before
    cpu = _port_state(cfg, 3)
    assert set(card) == set(cpu)
    for name, want in cpu.items():
        got = card[name].cpu()
        if _constant(want):
            assert torch.equal(got, want), name
        else:
            assert _ulp_gap(got.numpy(), want.numpy()) <= NORMAL_ULP, name
