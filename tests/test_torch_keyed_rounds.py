"""The RWSADMM trainers draw the reference's own batches, with nothing
injected.

Both packages run one round from the same state on the same round key,
each drawing its own minibatch indices and dropout masks: the port's
draws must equal the reference's key tree exactly (``split(key, Z)`` per
slot, then ``split(·, steps)`` per prox-SGD step, ``fold_in(·, 1)`` and
``fold_in(·, 2)`` for the CNN's masks), and x, z and y after the round
agree at the round tier's atol = rtol = 1e-6 (fp32; gradients differ in
the last bits, as XLA and torch sum matmuls and convolutions in other
orders). The narrow CNN (c1 = 4, c2 = 8) runs in fp32 like the baselines'
reduced CNN, whose convolution sums agree bit for bit between the
packages. Then a 10-round eager MLR run of each package from the same
initial weights, whose per-round losses agree within ``RUN_LOSS_TOL``,
the refused keywords, the walk keywords' chains, and on the card the
captured windows and the device parity of a seed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rwsadmm import RWSADMMHparams as RHP
from repro.data import make_image_dataset as r_images
from repro.data import pathological_split as r_split
from repro.data.loader import build_federated as r_build
from repro.fl.base import to_device_data as r_device
from repro.fl.fleet_trainer import FleetRWSADMMTrainer as RFleet
from repro.fl.rwsadmm_trainer import RWSADMMTrainer as RTrainer
from repro.fl.simulation import run_simulation as r_run
from repro.models import small as RS
from repro_torch import convert
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.data import build_federated, make_image_dataset, \
    pathological_split
from repro_torch.fl import FleetRWSADMMTrainer, RWSADMMTrainer, \
    run_simulation, to_device_data
from repro_torch.fl.base import UNPORTED
from repro_torch.models.small import CNN, MLP, MLR
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPE, N_CLIENTS, ZONE, BATCH, STEPS = (8, 8, 1), 10, 4, 6, 3
HP = dict(beta=10.0, kappa=0.01, epsilon=1e-3)
TOL = dict(atol=1e-6, rtol=1e-6)
# Ten eager MLR rounds of both packages from the same weights on the same
# draws: each round's gradients differ in the last bits and feed the
# next; the losses read at most 2.4e-7 apart, held at 1e-5.
RUN_LOSS_TOL = 1e-5


def _fed(pkg):
    images, split, build = ((r_images, r_split, r_build) if pkg == "ref"
                            else (make_image_dataset, pathological_split,
                                  build_federated))
    imgs, labels = images(300, shape=SHAPE, seed=0)
    return build(imgs, labels, split(labels, N_CLIENTS, seed=0), seed=0)


@pytest.fixture(scope="module")
def feds():
    return r_device(_fed("ref")), to_device_data(_fed("port"), "cpu")


def _models(kind):
    if kind == "cnn":
        return (RS.make_cnn(SHAPE, c1=4, c2=8, fc=16),
                CNN(SHAPE, c1=4, c2=8, fc=16))
    if kind == "mlp":
        return RS.make_mlp(SHAPE, hidden=16), MLP(SHAPE, hidden=16)
    return RS.make_mlr(SHAPE), MLR(SHAPE)


def _pair(feds, kind, solver, fleet_mode=None, seed=0):
    r_model, model = _models(kind)
    kw = dict(zone_size=ZONE, batch_size=BATCH, solver=solver,
              inner_steps=STEPS, inner_lr=0.05, seed=seed)
    if fleet_mode is not None:
        kw.update(n_walkers=3, sync_every=2, fleet_mode=fleet_mode)
        ref = RFleet(r_model, feds[0], RHP(**HP), scenario=None, **kw)
        port = FleetRWSADMMTrainer(model, feds[1], RWSADMMHparams(**HP),
                                   device="cpu", **kw)
    else:
        ref = RTrainer(r_model, feds[0], RHP(**HP), scenario=None, **kw)
        port = RWSADMMTrainer(model, feds[1], RWSADMMHparams(**HP),
                              device="cpu", **kw)
    r_state = ref.init_state(jax.random.PRNGKey(seed))
    y = r_state.base.server.y if fleet_mode else r_state.server.y
    params = convert._flat_rows(jax.tree_util.tree_map(np.asarray, y), 0)
    return ref, port, r_state, port.init_state(params=params)


def _rows(tree, lead):
    return convert._flat_rows(jax.tree_util.tree_map(np.asarray, tree),
                              lead).numpy()


def _ref_draws(keys, clients, n_train, model):
    """The reference's draws under each key: ``randint(k, (B,), 0,
    n_train[c])`` and, for the CNN, its two keep masks (the conv one
    moved to the port's NCHW layout)."""
    idx = np.stack([np.asarray(jax.random.randint(k, (BATCH,), 0,
                                                  int(n_train[c])))
                    for k, c in zip(keys, clients)])
    if not model.keep_probs:
        return idx, None
    shapes = model.dropout_shapes(BATCH)
    keep = tuple(np.stack([np.asarray(jax.random.bernoulli(
        jax.random.fold_in(k, i + 1), p, shape)) for k in keys])
        for i, (shape, p) in enumerate(zip(shapes, model.keep_probs)))
    return idx, (keep[0].transpose(0, 1, 4, 2, 3), keep[1])


def _assert_draws(port, clients, key, steps=None):
    """The port's draws for a zone and round key equal the reference's
    key tree, exactly."""
    idx, keep = port.zone_batch_indices(
        torch.as_tensor(clients, dtype=torch.int64),
        torch.as_tensor(key.astype(np.int64)), steps)
    slot_keys = jax.random.split(key, len(clients))
    n_train = port.data.n_train.numpy()
    if steps is None:
        want = _ref_draws(slot_keys, clients, n_train, port.model)
    else:
        per = [_ref_draws(jax.random.split(k, steps)[t:t + 1], [c],
                          n_train, port.model)
               for t in range(steps) for k, c in zip(slot_keys, clients)]
        want = (np.stack([d[0] for d in per]).reshape(steps, len(clients),
                                                      BATCH), None)
    assert np.array_equal(idx.numpy(), want[0])
    assert (keep is None) == (want[1] is None)
    for got, exp in zip(keep or (), want[1] or ()):
        assert np.array_equal(got.numpy(), exp)


@pytest.mark.parametrize("kind,solver,fused", [
    ("mlr", "closed_form", False), ("mlp", "closed_form", False),
    ("cnn", "closed_form", False), ("mlp", "closed_form", True),
    ("mlr", "prox_sgd", False)])
def test_single_walker_round_draws_the_reference_batches(feds, kind, solver,
                                                         fused):
    ref, port, r_state, state = _pair(feds, kind, solver)
    r_round = jax.jit(functools.partial(ref._round_impl, use_fused=fused))
    sched = ref.schedule(2, np.random.default_rng(3))
    for r in range(2):
        idx, mask, key = sched.idx[r], sched.mask[r], sched.keys[r]
        _assert_draws(port, idx, key,
                      None if solver == "closed_form" else STEPS)
        r_state, _ = r_round(r_state, jnp.asarray(idx), jnp.asarray(mask),
                             jnp.asarray(float(sched.n_i[r])),
                             jnp.asarray(key))
        state, _ = port._round_impl(
            state, torch.as_tensor(idx, dtype=torch.int64),
            torch.as_tensor(mask), torch.as_tensor(key.astype(np.int64)),
            use_fused=fused)
        np.testing.assert_allclose(state.clients.x.numpy(),
                                   _rows(r_state.clients.x, 1), **TOL)
        np.testing.assert_allclose(state.clients.z.numpy(),
                                   _rows(r_state.clients.z, 1), **TOL)
        np.testing.assert_allclose(state.server.y.numpy(),
                                   _rows(r_state.server.y, 0), **TOL)


@pytest.mark.parametrize("mode", ["roundrobin", "simultaneous"])
def test_fleet_round_draws_the_reference_batches(feds, mode):
    ref, port, r_state, state = _pair(feds, "mlp", "closed_form", mode)
    sched = ref.schedule(3, np.random.default_rng(5))
    step_fn = ref._fleet_step_fn(mode, False)
    for r in range(3):
        idx, mask, key = sched.idx[r], sched.mask[r], sched.keys[r]
        _assert_draws(port, idx.reshape(-1), key)
        tkey = torch.as_tensor(key.astype(np.int64))
        sync = torch.tensor(sched.sync[r])
        t_idx = torch.as_tensor(idx, dtype=torch.int64)
        if mode == "roundrobin":
            a = int(sched.walker[r])
            r_state, _ = step_fn(r_state, jnp.asarray(idx),
                                 jnp.asarray(mask),
                                 jnp.asarray(float(sched.n_i[r])),
                                 jnp.asarray(a, jnp.int32),
                                 jnp.asarray(sched.sync[r]), jnp.asarray(key))
            state, _ = port._rr_step(state, t_idx, torch.as_tensor(mask),
                                     torch.tensor(a), sync, tkey)
        else:
            r_state, _ = step_fn(r_state, jnp.asarray(idx),
                                 jnp.asarray(mask),
                                 jnp.asarray(sched.n_i[r]),
                                 jnp.asarray(sched.sync[r]), jnp.asarray(key))
            state, _ = port._sim_step(state, t_idx, torch.as_tensor(mask),
                                      sync, tkey)
        np.testing.assert_allclose(state.base.clients.x.numpy(),
                                   _rows(r_state.base.clients.x, 1), **TOL)
        np.testing.assert_allclose(state.base.clients.z.numpy(),
                                   _rows(r_state.base.clients.z, 1), **TOL)
        np.testing.assert_allclose(state.tokens.numpy(),
                                   _rows(r_state.tokens, 1), **TOL)


def test_eager_mlr_run_follows_the_reference(feds):
    """Ten eager rounds through ``run_simulation`` in both packages from
    the same initial weights: the same zones, and losses within
    ``RUN_LOSS_TOL`` round by round."""
    ref, port, r_state, state = _pair(feds, "mlr", "closed_form")
    port.init_state = lambda seed: state
    r_res = r_run(ref, rounds=10, eval_every=10, seed=0)
    res = run_simulation(port, rounds=10, eval_every=10, seed=0)
    for key in ("client", "zone", "comm_bytes"):
        assert [m[key] for m in res.round_metrics] == \
            [m[key] for m in r_res.round_metrics], key
    np.testing.assert_allclose([m["train_loss"] for m in res.round_metrics],
                               [m["train_loss"] for m in r_res.round_metrics],
                               atol=RUN_LOSS_TOL, rtol=RUN_LOSS_TOL)


@pytest.mark.parametrize("fleet", [False, True])
@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_keywords_name_their_item(feds, name, fleet):
    cls = FleetRWSADMMTrainer if fleet else RWSADMMTrainer
    item = UNPORTED[name].split(" (")[0]
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1 {item}"):
        cls(MLR(SHAPE), feds[1], device="cpu", **{name: object()})
    with pytest.raises(TypeError, match="no_such_argument"):
        cls(MLR(SHAPE), feds[1], device="cpu", no_such_argument=1)


def test_only_mesh_is_unported():
    """Telemetry, the lazy plane's store and prefetch, and DP uploads are
    ported; only the mesh waits."""
    assert set(UNPORTED) == {"mesh"}


#: each walk keyword with a value that moves the walker off the default
WALK_KEYWORDS = {"transition": dict(transition="metropolis"),
                 "walk_policy": dict(walk_policy="staleness"),
                 "walk_bias": dict(walk_policy="label_skew", walk_bias=0.5),
                 "batched_walk": dict(batched_walk=True)}


@pytest.mark.parametrize("fleet", [False, True])
@pytest.mark.parametrize("name", sorted(WALK_KEYWORDS))
def test_walk_keywords_build_the_reference_chain(feds, name, fleet):
    """The walk keywords (no longer refused): each trainer built with one
    runs the reference trainer's chain, walker by walker: transition,
    policy, bias, label weights and transition matrix on the current
    graph, then a 6-round schedule's visits and importance weights."""
    kw = dict(WALK_KEYWORDS[name], zone_size=ZONE, batch_size=BATCH, seed=0,
              solver="closed_form")
    if fleet:
        kw.update(n_walkers=3, fleet_mode="simultaneous")
    r_cls, cls = (RFleet, FleetRWSADMMTrainer) if fleet else (RTrainer,
                                                             RWSADMMTrainer)
    ref = r_cls(RS.make_mlr(SHAPE), feds[0], RHP(**HP), **kw)
    port = cls(MLR(SHAPE), feds[1], RWSADMMHparams(**HP), device="cpu", **kw)
    pairs = (list(zip(ref.walkers, port.walkers)) if fleet
             else [(ref.walker, port.walker)])
    graph = (port.dyn_graph.current(), ref.dyn_graph.current())
    for w_r, w_t in pairs:
        assert (w_t.transition, w_t.policy, w_t.bias_gamma) == \
            (w_r.transition, w_r.policy, w_r.bias_gamma)
        assert (w_t.label_weights is None) == (w_r.label_weights is None)
        if w_t.label_weights is not None:
            assert np.array_equal(w_t.label_weights, w_r.label_weights)
        assert np.array_equal(w_t.matrix(graph[0]), w_r.matrix(graph[1]))
    assert port.batched_walk == ref.batched_walk
    r_sched = ref.schedule(6, np.random.default_rng(1))
    sched = port.schedule(6, np.random.default_rng(1))
    assert np.array_equal(sched.clients, r_sched.clients)
    assert (sched.iw is None) == (r_sched.iw is None)
    if sched.iw is not None:
        assert np.array_equal(sched.iw, r_sched.iw)
    for w_r, w_t in pairs:
        assert w_t.weight_history == w_r.weight_history


# ----------------------------------------------------------------- card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (captured windows, the kernels)")
    return torch.device("cuda")


def _card_pair(fed, kind, device, **kw):
    _, model = _models(kind)
    data = to_device_data(fed, device)
    cls = FleetRWSADMMTrainer if "fleet_mode" in kw else RWSADMMTrainer
    return cls(model, data, RWSADMMHparams(**HP), zone_size=ZONE,
               batch_size=BATCH, solver="closed_form", device=device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", [{}, {"fleet_mode": "roundrobin"},
                                   {"fleet_mode": "simultaneous"}])
def test_captured_scan_equals_eager_on_card(cuda_device, fleet):
    """Two windows of the captured ``scan`` (the second a replay) equal
    eager rounds bit for bit; ``scan_fused`` equals a loop of the same
    rounds outside any graph."""
    fed = _fed("port")
    runs = {}
    for engine in ("eager", "scan", "scan_fused", "loop"):
        tr = _card_pair(fed, "cnn", cuda_device, **fleet)
        rng = np.random.default_rng(0)
        state = tr.init_state(0)
        if engine == "eager":
            for r in range(8):
                state, _ = tr.round(state, r, rng)
        for start in ((0, 4) if engine != "eager" else ()):
            sched = tr.schedule(4, rng, start_round=start)
            if engine == "loop":
                ins = {k: torch.as_tensor(v, device=cuda_device)
                       for k, v in tr._window_columns(sched).items()}
                state, _, _ = tr._window(state, ins, True)
            else:
                state, _ = tr.run_chunk(state, sched, engine)
        torch.cuda.synchronize()
        runs[engine] = [t.clone() for t in (
            (state.base if fleet else state).clients.x,
            (state.base if fleet else state).server.y)]
    assert all(torch.equal(a, b) for a, b in zip(runs["eager"], runs["scan"]))
    assert all(torch.equal(a, b)
               for a, b in zip(runs["loop"], runs["scan_fused"]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mlr", "mlp"])
def test_seed_trains_alike_on_card_and_cpu(cuda_device, kind):
    """Five eager rounds on the card and on the CPU from one seed, TF32
    off: the same draws, so x, z and y agree at 1e-6."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        fed, out = _fed("port"), {}
        for device in ("cpu", cuda_device):
            tr = _card_pair(fed, kind, device)
            rng, state = np.random.default_rng(0), tr.init_state(0)
            for r in range(5):
                state, _ = tr.round(state, r, rng)
            out[str(device)] = [t.cpu() for t in (
                state.clients.x, state.clients.z, state.server.y)]
        for a, b in zip(*out.values()):
            torch.testing.assert_close(a, b, **TOL)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
