"""The port's small models against ``repro.models.small``.

Both packages start from the reference's params (carried over with
``repro_torch.convert``) and see the same numpy inputs. Logits and
per-leaf gradients of ``cross_entropy`` with ``train=False`` agree at
rtol 1e-5 / atol 1e-5 for MLR and MLP (same matmuls, different summation
order: a logit near zero that sums 784 O(1) products keeps ~1e-6 of
absolute rounding, beyond any rtol) and at rtol 1e-4 / atol 1e-5 for the CNN, whose convolutions sum
in yet another order.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import tree as rtree
from repro.models import small as R
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.core.tree import ParamLayout
from repro_torch.models import small as T
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

DENSE_TOL = dict(rtol=1e-5, atol=1e-5)
CNN_TOL = dict(rtol=1e-4, atol=1e-5)
SHAPES = {"mnist": (28, 28, 1), "cifar": (32, 32, 3)}


def _pair(kind, shape):
    if kind == "mlr":
        return R.make_mlr(shape), T.MLR(shape), DENSE_TOL
    if kind == "mlp":
        return R.make_mlp(shape, hidden=16), T.MLP(shape, hidden=16), \
            DENSE_TOL
    return (R.make_cnn(shape, c1=4, c2=8, fc=32),
            T.CNN(shape, c1=4, c2=8, fc=32), CNN_TOL)


def _setup(kind, data, seed=0):
    shape = SHAPES[data]
    ref, port, tol = _pair(kind, shape)
    params = jax.tree_util.tree_map(np.asarray,
                                    ref.init(jax.random.PRNGKey(seed)))
    convert.load_reference(port, params)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6,) + shape).astype(np.float32)
    y = rng.integers(0, 10, 6).astype(np.int32)
    return ref, port, params, x, y, tol


@pytest.mark.parametrize("data", ["mnist", "cifar"])
@pytest.mark.parametrize("kind", ["mlr", "mlp", "cnn"])
def test_logits_and_grads_match(kind, data):
    ref, port, params, x, y, tol = _setup(kind, data)
    logits_r = ref.apply(params, x, train=False)
    logits_t = port(torch.from_numpy(x))
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_r), **tol)

    g_ref = jax.grad(lambda p: R.cross_entropy(
        ref.apply(p, x, train=False), y))(params)
    loss = T.cross_entropy(port(torch.from_numpy(x)),
                           torch.from_numpy(y).long())
    loss.backward()
    g_port = {n: p.grad for n, p in port.named_parameters()}
    ref_flat = convert.state_from_reference(g_ref)
    assert set(ref_flat) == set(g_port)
    for name, g in g_port.items():
        np.testing.assert_allclose(g.numpy(), ref_flat[name].numpy(),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_masked_loss_and_accuracy_match(kind):
    ref, port, params, x, y, tol = _setup(kind, "cifar", seed=3)
    m = np.array([1, 1, 0, 1, 0, 1], np.float32)
    logits = ref.apply(params, x, train=False)
    lt = torch.from_numpy(np.array(logits))
    yt, mt = torch.from_numpy(y), torch.from_numpy(m)
    np.testing.assert_allclose(float(T.cross_entropy(lt, yt, mt)),
                               float(R.cross_entropy(logits, y, m)),
                               rtol=1e-6)
    assert float(T.accuracy(lt, yt, mt)) == float(R.accuracy(logits, y, m))
    assert float(T.accuracy(lt, yt)) == float(R.accuracy(logits, y))


@pytest.mark.parametrize("kind", ["mlr", "mlp", "cnn"])
def test_flat_layout_matches_reference_flatten(kind):
    _, port, params, *_ = _setup(kind, "mnist", seed=1)
    layout = ParamLayout.from_module(port)
    paths = [".".join(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    assert list(layout.names) == paths
    ref_flat = np.asarray(rtree.flatten(params))
    flat = convert.flat_from_reference(params, layout)
    assert np.array_equal(flat.numpy(), ref_flat)
    assert layout.size == rtree.n_params(params)
    assert np.array_equal(
        layout.flatten(dict(port.named_parameters())).detach().numpy(),
        ref_flat)
    views = layout.views(flat)
    assert [tuple(v.shape) for v in views.values()] == list(layout.shapes)
    assert torch.equal(layout.flatten(views), flat)


@pytest.mark.parametrize("kind", ["mlr", "mlp", "cnn"])
def test_convert_round_trip(kind):
    _, port, params, *_ = _setup(kind, "cifar", seed=2)
    layout = ParamLayout.from_module(port)
    back = convert.state_to_reference(convert.state_from_reference(params))
    flat_back = convert.flat_to_reference(
        convert.flat_from_reference(params, layout), layout)
    for tree in (back, flat_back):
        assert jax.tree_util.tree_structure(tree) == \
            jax.tree_util.tree_structure(params)
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(params)):
            assert a.dtype == np.float32 and np.array_equal(a, b)


def test_cnn_full_width_param_count():
    ref = R.make_cnn((32, 32, 3))
    port = T.CNN((32, 32, 3))
    n_ref = rtree.n_params(ref.init(jax.random.PRNGKey(0)))
    assert ParamLayout.from_module(port).size == n_ref == 1_068_266


def test_dropout_keep_rate_and_scaling():
    model = T.CNN((32, 32, 3), c1=4, c2=8, fc=32)
    keep = model.draw_keep(prng.prng_key(0), 4096)
    assert [tuple(k.shape) for k in keep] == [(4096, 4, 16, 16), (4096, 32)]
    for k, p in zip(keep, model.keep_probs):
        # Binomial standard error of the keep rate is < 1e-3 here.
        assert abs(float(k.float().mean()) - p) < 5e-3
        out = T._dropout(torch.ones(k.shape), k, p)
        assert bool(((out == 0) | (out == 1.0 / p)).all())
        assert abs(float(out.mean()) - 1.0) < 1e-2   # 1/keep rescaling
    x = torch.randn(8, 32, 32, 3)
    a = model(x, train=True, keep=model.draw_keep(prng.prng_key(1), 8))
    b = model(x, train=True, keep=model.draw_keep(prng.prng_key(1), 8))
    assert torch.equal(a, b)
    assert not torch.equal(a, model(x, train=False))
    assert torch.equal(model(x, train=False), model(x))
