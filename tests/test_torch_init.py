"""A seed's initial weights in the port are the reference's.

The reference starts every trainer from ``model.init(PRNGKey(seed))``,
whose small models draw ``jax.random.normal`` along ``split`` (one key
for MLR's single layer, ``split(key, 3)`` for the MLP, ``split(key, 4)``
for the CNN; a dense layer draws under ``split(key)[0]``, a conv under
its key itself). The port's ``init_params(prng_key(seed))`` walks the
same tree with ``core/prng.py``, whose normals are the reference's bits
through erf⁻¹ within ``NORMAL_ULP`` ulp. The draws are held at that gap
before the scale (against ``jax.random.normal`` along the tree) and the
scaled leaves at the same gap against ``model.init`` itself (the scale is
one fp32 product in both packages, and no rounding read more than the
draws' gap). Biases are zeros in both.

Every trainer's ``init_state(seed)``, with nothing injected, then holds
the reference's ``init_state(PRNGKey(seed))`` at that gap, and the
quickstart twin's first rounds run the reference's host columns by
``==`` with losses within ``RUN_LOSS_TOL``.
"""
import math

import jax
import numpy as np
import pytest

import repro.baselines as RB
from repro.core.rwsadmm import RWSADMMHparams as RHP
from repro.data import make_image_dataset as r_images
from repro.data import pathological_split as r_split
from repro.data.loader import build_federated as r_build
from repro.fl.base import to_device_data as r_device
from repro.fl.fleet_trainer import FleetRWSADMMTrainer as RFleet
from repro.fl.rwsadmm_trainer import RWSADMMTrainer as RTrainer
from repro.fl.simulation import run_simulation as r_run
from repro.models import small as RS
from repro_torch import baselines as TB
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.data import build_federated, factory_from_federated, \
    make_image_dataset, pathological_split
from repro_torch.fl import FleetRWSADMMTrainer, RWSADMMTrainer, \
    run_simulation, to_device_data
from repro_torch.models.small import get_model
from test_torch_privacy import NORMAL_ULP, _ulp_gap
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SEEDS = (0, 1, 1234)
#: the models at the paper's widths, on their datasets' input shapes
MODELS = {"mlr": (28, 28, 1), "mlp": (28, 28, 1), "cnn": (32, 32, 3)}
SHAPE, N_CLIENTS = (8, 8, 1), 10
HP = dict(beta=10.0, kappa=0.01, epsilon=1e-3)
# The quickstart's first rounds from both packages' own inits: the draws
# are equal and the inits within NORMAL_ULP, so the losses part only by
# gradients summed in other orders (read: ≤ 7.8e-7 after 3 rounds).
RUN_LOSS_TOL = 1e-5


def _ref_draws(name, shape, key):
    """``jax.random.normal`` along the reference's key tree, unscaled:
    ``{"<layer>.w": draw}``."""
    def dense(k, shape):
        return np.asarray(jax.random.normal(jax.random.split(k)[0], shape))

    n_in = math.prod(shape)
    if name == "mlr":
        return {"linear.w": dense(key, (n_in, 10))}
    if name == "mlp":
        k1, k2, k3 = jax.random.split(key, 3)
        return {"fc1.w": dense(k1, (n_in, 100)),
                "fc2.w": dense(k2, (100, 100)),
                "out.w": dense(k3, (100, 10))}
    k1, k2, k3, k4 = jax.random.split(key, 4)
    h, w, c = shape
    return {"conv1.w": np.asarray(jax.random.normal(k1, (5, 5, c, 16))),
            "conv2.w": np.asarray(jax.random.normal(k2, (5, 5, 16, 32))),
            "fc.w": dense(k3, ((h // 4) * (w // 4) * 32, 512)),
            "out.w": dense(k4, (512, 10))}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_params_follow_the_reference_key_tree(name, seed):
    shape = MODELS[name]
    model = get_model(name, shape)
    got = model.init_params(prng.prng_key(seed))
    want = convert.state_from_reference(
        RS.get_model(name, shape).init(jax.random.PRNGKey(seed)))
    assert set(got) == set(want)
    draws = _ref_draws(name, shape, jax.random.PRNGKey(seed))
    layers = dict(model.named_children())
    for leaf, value in got.items():
        assert value.dtype == want[leaf].dtype
        assert tuple(value.shape) == tuple(want[leaf].shape), leaf
        if leaf.endswith(".b"):
            assert not value.any() and not want[leaf].any()
            continue
        # The leaf is its key's draw times the layer's scale, exactly;
        # the draw is the reference's within NORMAL_ULP.
        draw = prng.normal(_leaf_key(name, leaf, seed), value.shape)
        assert _ulp_gap(draw.numpy(), draws[leaf]) <= NORMAL_ULP, leaf
        scale = layers[leaf.split(".")[0]].scale
        np.testing.assert_array_equal(value.numpy(), (draw * scale).numpy())
        assert _ulp_gap(value.numpy(), want[leaf].numpy()) <= NORMAL_ULP, \
            leaf


def _leaf_key(name, leaf, seed):
    """The port's key for a weight leaf, walked as the reference does."""
    key = prng.prng_key(seed)
    order = {"mlr": ["linear"], "mlp": ["fc1", "fc2", "out"],
             "cnn": ["conv1", "conv2", "fc", "out"]}[name]
    layer = leaf.split(".")[0]
    if len(order) > 1:
        key = prng.split(key, len(order))[order.index(layer)]
    return key if layer.startswith("conv") else prng.split(key)[0]


def test_module_weights_are_seed_zero():
    model = get_model("mlp", SHAPE)
    want = model.init_params(prng.prng_key(0))
    for name, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), want[name].numpy())


# ------------------------------------------------------------ trainers --
def _fed(pkg):
    images, split, build = ((r_images, r_split, r_build) if pkg == "ref"
                            else (make_image_dataset, pathological_split,
                                  build_federated))
    imgs, labels = images(300, shape=SHAPE, seed=0)
    return build(imgs, labels, split(labels, N_CLIENTS, seed=0), seed=0)


@pytest.fixture(scope="module")
def feds():
    fed = _fed("port")
    return (r_device(_fed("ref")), to_device_data(fed, "cpu"),
            factory_from_federated(fed))


def _rows(tree, lead):
    return convert._flat_rows(jax.tree_util.tree_map(np.asarray, tree),
                              lead).numpy()


def _rwsadmm_pair(kind, feds, fleet, lazy=False):
    r_model, model = RS.get_model(kind, SHAPE), get_model(kind, SHAPE)
    kw = dict(zone_size=4, batch_size=6, solver="closed_form", seed=0)
    data = feds[2] if lazy else feds[1]
    extra = dict(store_capacity=6) if lazy else {}
    if fleet:
        kw.update(n_walkers=3, sync_every=2, fleet_mode="simultaneous")
        return (RFleet(r_model, feds[0], RHP(**HP), scenario=None, **kw),
                FleetRWSADMMTrainer(model, data, RWSADMMHparams(**HP),
                                    device="cpu", **kw, **extra))
    return (RTrainer(r_model, feds[0], RHP(**HP), scenario=None, **kw),
            RWSADMMTrainer(model, data, RWSADMMHparams(**HP), device="cpu",
                           **kw, **extra))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind,fleet,lazy", [
    ("mlr", False, False), ("mlp", False, False), ("mlp", True, False),
    ("mlp", False, True), ("mlp", True, True)])
def test_rwsadmm_init_state_is_the_reference(kind, fleet, lazy, seed, feds):
    ref, port = _rwsadmm_pair(kind, feds, fleet, lazy)
    r_state = ref.init_state(jax.random.PRNGKey(seed))
    state = port.init_state(seed)
    r_base = r_state.base if fleet else r_state
    base = state.base if fleet else state
    pairs = [(base.server.y.numpy(), _rows(r_base.server.y, 0))]
    if fleet:
        pairs.append((state.tokens.numpy(), _rows(r_state.tokens, 1)))
    if not lazy:
        pairs += [(base.clients.x.numpy(), _rows(r_base.clients.x, 1)),
                  (base.clients.z.numpy(), _rows(r_base.clients.z, 1))]
    for got, want in pairs:
        assert got.shape == want.shape
        assert _ulp_gap(got, want) <= NORMAL_ULP


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["fedavg", "perfedavg", "pfedme", "ditto",
                                  "apfl", "walkman"])
def test_baseline_init_state_is_the_reference(name, seed, feds):
    kw = {} if name == "walkman" else {"clients_per_round": 3}
    ref = RB.REGISTRY[name](RS.get_model("mlp", SHAPE), feds[0],
                            batch_size=6, **kw)
    port = TB.REGISTRY[name](get_model("mlp", SHAPE), feds[1], batch_size=6,
                             device="cpu", **kw)
    want = convert.baseline_state_from_reference(
        name, jax.tree_util.tree_map(np.asarray,
                                     ref.init_state(jax.random.PRNGKey(seed))))
    got = port.init_state(seed)
    for field, w in zip(want._fields, want):
        g = getattr(got, field)
        if field == "round":
            assert int(g) == int(w)
            continue
        for gl, wl in zip(jax.tree_util.tree_leaves(tuple(g)) if
                          isinstance(g, tuple) else [g],
                          jax.tree_util.tree_leaves(tuple(w)) if
                          isinstance(w, tuple) else [w]):
            assert gl.shape == wl.shape, field
            assert _ulp_gap(gl.numpy(), wl.numpy()) <= NORMAL_ULP, field


# ---------------------------------------------------------- quickstart --
QUICKSTART_ROUNDS = 3


def _quickstart(pkg):
    """The quickstart's data, model and RWSADMM trainer (its settings,
    ``examples/quickstart.py``), in either package."""
    if pkg == "ref":
        imgs, labels = r_images(3000, seed=0)
        parts = r_split(labels, n_clients=20, labels_per_client=2, seed=0)
        data = r_device(r_build(imgs, labels, parts))
        return RTrainer(RS.get_model("mlp", (28, 28, 1)), data,
                        RHP(beta=1.0, kappa=0.001, epsilon=1e-5),
                        zone_size=8, batch_size=32, min_degree=5,
                        regen_every=10)
    imgs, labels = make_image_dataset(3000, seed=0)
    parts = pathological_split(labels, n_clients=20, labels_per_client=2,
                               seed=0)
    data = to_device_data(build_federated(imgs, labels, parts), "cpu")
    return RWSADMMTrainer(get_model("mlp", (28, 28, 1)), data,
                          RWSADMMHparams(beta=1.0, kappa=0.001,
                                         epsilon=1e-5),
                          zone_size=8, batch_size=32, min_degree=5,
                          regen_every=10, device="cpu")


def test_quickstart_twin_starts_as_the_reference():
    """A few of the quickstart's rounds, each package from its own seed-0
    init: equal host columns, losses within ``RUN_LOSS_TOL``."""
    kw = dict(rounds=QUICKSTART_ROUNDS, eval_every=QUICKSTART_ROUNDS,
              engine="scan")
    r_res = r_run(_quickstart("ref"), **kw)
    res = run_simulation(_quickstart("port"), **kw)
    cols = ("client", "zone", "n_i", "comm_bytes", "latency_s", "energy_j",
            "staleness_p50", "staleness_max")
    for col in cols:
        assert [m.get(col) for m in res.round_metrics] == \
            [m.get(col) for m in r_res.round_metrics], col
    np.testing.assert_allclose(
        [m["train_loss"] for m in res.round_metrics],
        [float(m["train_loss"]) for m in r_res.round_metrics],
        rtol=RUN_LOSS_TOL, atol=RUN_LOSS_TOL)
    assert res.total_comm_bytes == r_res.total_comm_bytes
