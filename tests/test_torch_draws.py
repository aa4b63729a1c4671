"""``prng.draws`` (one ``threefry_draws`` launch a round) against
``jax.random``'s own key tree, bit for bit.

A round's draws are, under each leaf key of ``split(key, Z)`` (or of
``split(k, steps)`` for each of Z keys, step-major, as prox-SGD and the
cohort baselines walk them), ``randint(leaf, (B,), 0, n_train[client])``
and, for the CNN, ``bernoulli(fold_in(leaf, i + 1), p, shape)`` per
dropout layer, the conv block's stored NCHW. The port must give exactly
those integers and bits on the CPU (its plain version); on the card the
kernel is held to the plain version by the ``cuda``-marked test. No
tolerance: these are integers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.kernels.threefry import ops
from repro_torch.kernels.threefry.ref import MaskSpec, draws_ref
from repro_torch.models.small import CNN, MLR
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SEED, BATCH = 20240611, 20
#: a client table with the edge spans: 1, 2^31 − 1 and 0 (minval back)
SPANS = np.array([1, 7, 150, 600, 4999, 70_000, 2**31 - 1, 0, 3, 40])
NARROW = CNN((8, 8, 3), c1=4, c2=8, fc=16)
MODELS = {"cnn": NARROW, "mlr": MLR((8, 8, 3))}


def _ref_leaf(leaf, span, masks):
    """One leaf's draws by ``jax.random``: the indices, then each mask in
    the port's layout."""
    idx = jax.random.randint(leaf, (BATCH,), 0, span)
    out = [idx]
    for i, spec in enumerate(masks):
        keep = jax.random.bernoulli(jax.random.fold_in(leaf, i + 1), spec.p,
                                    spec.shape)
        out.append(jnp.moveaxis(keep, -1, 1) if spec.channels_first
                   else keep)
    return out


def _ref_draws(leaves, spans, masks):
    """``_ref_leaf`` over a (..., 2) array of leaf keys, one span each
    (leaf by leaf: ``jax.random``'s compiled functions are reused across
    leaves and tests, where a vmap would compile per leaf count)."""
    lead = leaves.shape[:-1]
    per = [_ref_leaf(k, int(s), masks) for k, s in
           zip(leaves.reshape(-1, 2), np.reshape(spans, -1))]
    return [np.stack([np.asarray(d[i]) for d in per]).reshape(
        lead + per[0][i].shape) for i in range(len(per[0]))]


def _assert_equal(got, want):
    idx, keep = got
    got = [idx.numpy().astype(np.int64)] + [k.numpy() for k in keep]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g, w.astype(g.dtype))


@pytest.mark.parametrize("model", ["cnn", "mlr"])
@pytest.mark.parametrize("z", [1, 8, 24])
def test_zone_round_equals_jax_tree(z, model):
    """``split(key, Z)`` in the launch, each leaf's client in the span
    table (the edge spans included)."""
    masks = MODELS[model].keep_masks(BATCH)
    key = jax.random.PRNGKey(SEED + z)
    clients = (np.arange(z) * 3) % len(SPANS)
    got = prng.draws(torch.as_tensor(np.asarray(key).astype(np.int64)),
                     split=z, batch=BATCH, spans=torch.as_tensor(SPANS),
                     clients=torch.as_tensor(clients), masks=masks)
    want = _ref_draws(jax.random.split(key, z), SPANS[clients], masks)
    _assert_equal(got, want)


@pytest.mark.parametrize("model", ["cnn", "mlr"])
def test_step_major_tree_equals_jax_tree(model):
    """Prox-SGD's and the cohort baselines' tree: Z slot keys, each split
    ``steps`` ways in the launch, step-major ``(steps, Z)``."""
    masks, steps, z = MODELS[model].keep_masks(BATCH), 3, 5
    slots = jax.random.split(jax.random.PRNGKey(SEED), z)
    clients = np.array([6, 0, 7, 2, 9])
    got = prng.draws(torch.as_tensor(np.asarray(slots).astype(np.int64)),
                     split=steps, batch=BATCH, spans=torch.as_tensor(SPANS),
                     clients=torch.as_tensor(clients), masks=masks)
    leaves = jnp.swapaxes(jax.vmap(lambda k: jax.random.split(k, steps))(
        slots), 0, 1)
    want = _ref_draws(leaves, np.broadcast_to(SPANS[clients], (steps, z)),
                      masks)
    _assert_equal(got, want)


def test_leaves_without_split_and_table_without_clients():
    """Keys ``(2, 4, 2)`` drawn as they are, leaf l's span ``spans[l %
    S]``; and a minval above some spans."""
    keys = jax.random.split(jax.random.PRNGKey(SEED), 8).reshape(2, 4, 2)
    spans = SPANS[:4]
    got = prng.draws(torch.as_tensor(np.asarray(keys).astype(np.int64)),
                     batch=BATCH, spans=torch.as_tensor(spans), minval=5)
    want = np.stack([np.asarray(jax.random.randint(k, (BATCH,), 5, int(s)))
                     for k, s in zip(keys.reshape(-1, 2), np.tile(spans, 2))]
                    ).reshape(2, 4, BATCH)
    _assert_equal((got[0], ()), [want])


def test_draw_keep_unchanged():
    """``draw_keep`` gives the masks it gave before the fused draw:
    ``bernoulli(fold_in(key, i + 1), p, shape)``, the conv block's moved
    to NCHW, now stored contiguous."""
    keys = jax.random.split(jax.random.PRNGKey(3), 6).reshape(2, 3, 2)
    got = NARROW.draw_keep(torch.as_tensor(np.asarray(keys).astype(
        np.int64)), BATCH)
    old = [prng.bernoulli(prng.fold_in(torch.as_tensor(np.asarray(
        keys).astype(np.int64)), i + 1), p, shape)
        for i, (shape, p) in enumerate(zip(NARROW.dropout_shapes(BATCH),
                                           NARROW.keep_probs))]
    assert torch.equal(got[0], old[0].movedim(-1, -3))
    assert torch.equal(got[1], old[1])
    assert got[0].is_contiguous() and got[0].shape == (2, 3, BATCH, 4, 4, 4)
    _assert_equal((torch.zeros(2, 3, 0), got),
                  [np.zeros((2, 3, 0))] + _ref_draws(
                      keys, np.zeros((2, 3)), NARROW.keep_masks(BATCH))[1:])


def test_mask_spec_layouts():
    spec = MaskSpec((20, 16, 16, 16), 0.75, channels_first=True)
    assert spec.out_shape == (20, 16, 16, 16) and spec.dims() == (
        81_920, 16, 256)
    spec = MaskSpec((20, 6, 5, 3), 0.5, channels_first=True)
    assert spec.out_shape == (20, 3, 6, 5) and spec.dims() == (1800, 3, 30)
    assert MaskSpec((20, 512), 0.5).dims() == (10_240, 1, 10_240)


def test_draws_refuses_bad_arguments():
    keys = torch.zeros(3, 2, dtype=torch.int64)
    spans = torch.ones(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="spans"):
        ops.threefry_draws(keys, batch=4)
    with pytest.raises(ValueError, match="spans"):
        ops.threefry_draws(keys, batch=4, spans=spans.int())
    with pytest.raises(ValueError, match="split"):
        ops.threefry_draws(keys, split=0, batch=4, spans=spans)
    with pytest.raises(ValueError, match="at most 2 masks"):
        ops.threefry_draws(keys, masks=(MaskSpec((2,), 0.5),) * 3)
    with pytest.raises(ValueError, match="2\\^31"):
        ops.threefry_draws(keys, masks=(MaskSpec((2**16, 2**15), 0.5),))
    with pytest.raises(ValueError, match="clients"):
        ops.threefry_draws(keys, batch=4, spans=spans,
                           clients=torch.ones(2, 2, dtype=torch.int64))


# ----------------------------------------------------------------- card --
@pytest.mark.cuda
def test_draws_kernel_matches_plain_version_on_card():
    """The full-width CNN's round at 8 and 24 leaves, the step-major tree,
    the edge spans with and without a client table, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the threefry kernel)")
    dev = torch.device("cuda")
    masks = CNN((32, 32, 3)).keep_masks(BATCH)
    key = prng.prng_key(SEED, dev)[None]
    slots = prng.split(key[0], 8)
    spans = torch.as_tensor(SPANS, device=dev)
    cases = [(key, dict(split=z, batch=BATCH, spans=spans, masks=masks,
                        clients=torch.arange(z, device=dev) % len(SPANS)))
             for z in (8, 24)]
    cases += [(slots, dict(split=3, batch=BATCH, spans=spans, masks=masks,
                           clients=torch.arange(8, device=dev))),
              (slots, dict(batch=BATCH, spans=spans, minval=3, masks=masks)),
              (slots, dict(masks=(MaskSpec((1000,), 0.75),), fold=False))]
    for src, kw in cases:
        before = ops.threefry_draws.launches
        idx, keep = ops.threefry_draws(src, **kw)
        torch.cuda.synchronize()
        assert ops.threefry_draws.launches == before + 1
        want_idx, want_keep = draws_ref(src, **kw)
        assert torch.equal(idx, want_idx), kw
        for g, w in zip(keep, want_keep, strict=True):
            assert torch.equal(g, w), kw
