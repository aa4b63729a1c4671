"""``core/prng.py`` against ``jax.random``, bit for bit.

The port draws every minibatch and dropout mask from threefry keys; each
function must give the reference's exact bits (JAX 0.9 with
``jax_threefry_partitionable`` on): ``PRNGKey``, ``split``, ``fold_in``,
``uniform``, ``bernoulli`` on the CNN's NHWC mask shapes, ``randint``
over spans from 1 to 2^31 − 1, and a batch of keys in one call. There is
no tolerance: these are integers. On the card the kernel is held to the
plain version, bit for bit, by the ``cuda``-marked test.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.kernels.threefry import ops
from repro_torch.kernels.threefry.ref import MaskSpec
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SEED = 20240611
#: the CIFAR CNN's two keep-mask shapes at batch 20 (NHWC, then dense)
MASKS = {"conv": (20, 16, 16, 16), "dense": (20, 512)}


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 7, SEED, 2**31 - 2])
def test_prng_key(seed):
    assert np.array_equal(prng.prng_key(seed).numpy(),
                          _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [1, 2, 8, 1000])
def test_split(num):
    got = prng.split(prng.prng_key(SEED), num)
    assert got.shape == (num, 2)
    assert np.array_equal(got.numpy(),
                          _words(jax.random.split(jax.random.PRNGKey(SEED),
                                                  num)))


@pytest.mark.parametrize("data", [1, 2, 7, 97])
def test_fold_in(data):
    assert np.array_equal(
        prng.fold_in(prng.prng_key(SEED), data).numpy(),
        _words(jax.random.fold_in(jax.random.PRNGKey(SEED), data)))


@pytest.mark.parametrize("shape", [(20, 16, 16, 16), (7,), (3, 5)])
def test_uniform(shape):
    got = prng.uniform(prng.prng_key(SEED), shape)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(
        jax.random.uniform(jax.random.PRNGKey(SEED), shape)))


@pytest.mark.parametrize("p,mask", [(0.75, "conv"), (0.5, "dense"),
                                    (0.75, "dense"), (0.5, "conv")])
def test_bernoulli(p, mask):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 1)
    got = prng.bernoulli(torch.as_tensor(_words(key)), p, MASKS[mask])
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(
        jax.random.bernoulli(key, p, MASKS[mask])))


@pytest.mark.parametrize("span", [1, 7, 600, 70_000, 2**31 - 1])
def test_randint(span):
    got = prng.randint(prng.prng_key(SEED), (20,), 0, span)
    want = jax.random.randint(jax.random.PRNGKey(SEED), (20,), 0, span)
    assert np.array_equal(got.numpy(), _words(want))


def test_randint_empty_span_returns_minval():
    got = prng.randint(prng.prng_key(SEED), (20,), 0, 0)
    want = jax.random.randint(jax.random.PRNGKey(SEED), (20,), 0, 0)
    assert not got.any() and np.array_equal(got.numpy(), _words(want))


def test_batched_keys_draw_per_row():
    """One call over a (2, 4) batch of keys with one span per key equals
    the per-key draws, as the zone's slots use it; the CNN's masks
    likewise."""
    keys = jax.random.split(jax.random.PRNGKey(SEED), 8)
    spans = np.array([1, 7, 150, 600, 4999, 70_000, 2**31 - 1, 3])
    tkeys = torch.as_tensor(_words(keys)).reshape(2, 4, 2)
    got = prng.randint(tkeys, (20,), 0, torch.as_tensor(spans).reshape(2, 4))
    want = np.stack([_words(jax.random.randint(k, (20,), 0, int(s)))
                     for k, s in zip(keys, spans)]).reshape(2, 4, 20)
    assert np.array_equal(got.numpy(), want)
    masks = prng.bernoulli(tkeys, 0.5, (20, 32))
    want = np.stack([np.asarray(jax.random.bernoulli(k, 0.5, (20, 32)))
                     for k in keys]).reshape(2, 4, 20, 32)
    assert np.array_equal(masks.numpy(), want)


def test_wrappers_refuse_bad_keys():
    with pytest.raises(ValueError, match="keys must be"):
        ops.threefry_bits(torch.zeros(3, dtype=torch.int64), 4)
    with pytest.raises(TypeError, match="int64"):
        ops.threefry_bits(torch.zeros(3, 2, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="spans"):
        ops.threefry_draws(torch.zeros(3, 2, dtype=torch.int64), batch=4,
                           spans=torch.ones(2, 1, dtype=torch.int64))


# ----------------------------------------------------------------- card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the threefry kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(cuda_device):
    """Each entry at the CNN round's shapes, bit for bit (``bernoulli``
    and ``randint`` as ``threefry_draws`` with one output)."""
    keys = prng.split(prng.prng_key(SEED), 8)
    spans = torch.tensor([1, 7, 150, 600, 4999, 70_000, 2**31 - 1, 0])
    n = int(np.prod(MASKS["conv"]))
    cases = {
        "pairs": (lambda k: ops.threefry_bits(k, 1000, pair=True), None),
        "fold": (lambda k: ops.threefry_bits(k, 1, offset=97, pair=True),
                 None),
        "bits": (lambda k: ops.threefry_bits(k, n), None),
        "bernoulli": (lambda k: ops.threefry_draws(
            k, masks=(MaskSpec((n,), 0.75),), fold=False)[1][0], None),
        "randint": (lambda k, s: ops.threefry_draws(k, batch=20, spans=s)[0],
                    spans),
    }
    for name, (fn, extra) in cases.items():
        args = () if extra is None else (extra,)
        want = fn(keys, *args)
        got = fn(keys.to(cuda_device),
                 *(a.to(cuda_device) for a in args))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), name
