"""The port's baselines (FedAvg, Per-FedAvg, pFedMe, Ditto, APFL, Walkman)
against the JAX package's, on the CPU.

* Data: ``make_synthetic_lr``, ``make_mnist_like`` and
  ``build_federated_from_pairs`` give the reference's arrays bit for bit.
* Round tier: both packages start from the reference's initial state
  (``convert.baseline_state_from_reference``) and run one round on one
  round key, each drawing its own batches: the port's batch indices and
  CNN keep masks must equal what the reference's key chain draws
  (computed here with ``jax.random``) exactly, and the results agree at
  atol = rtol = ``TOL`` (1e-6, the reference's kernels' own), the cohort
  averages included.
* The float64 round at the paper's full CNN widths lives in
  ``test_torch_baselines_float64*.py`` (two files, so that the test
  workers can share its cost).
* Run tier: 30 rounds of ``run_simulation`` in both packages from the
  same initial state: cohorts, Walkman's visited clients and
  ``comm_bytes`` exactly equal (host RNG lockstep), final accuracy
  within ``RUN_BAND``.
* Per-FedAvg's and pFedMe's fixed-seed evaluation, Ditto's
  ``add(new − old)`` scatter bit for bit, the arguments the port
  refuses, and which baselines take a client data factory.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.baselines as RB
from repro.data import make_synthetic_lr as r_synthetic_lr
from repro.data.loader import build_federated as r_build
from repro.data.loader import build_federated_from_pairs as r_from_pairs
from repro.data.synthetic_images import make_mnist_like as r_mnist_like
from repro.data import pathological_split as r_split
from repro.fl.base import to_device_data as r_device
from repro.fl.simulation import run_simulation as r_run
from repro.models import small as RS
from repro_torch import baselines as TB
from repro_torch import convert
from repro_torch.core import prng, walkman
from repro_torch.data import build_federated, build_federated_from_pairs, \
    make_mnist_like, make_synthetic_lr, pathological_split
from repro_torch.fl.base import step_keys, to_device_data, \
    validate_round_metrics
from repro_torch.fl.simulation import run_simulation
from repro_torch.models.small import CNN, get_model
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_SAMPLES, N_CLIENTS, SHAPE, BATCH = 400, 8, (28, 28, 1), 20
COHORT = np.array([5, 2, 7])          # a round's cohort (m = 3)
# Every round-tier result, the weighted and plain cohort averages and
# pFedMe's 25 chained prox steps included, read at most 2.4e-7 apart
# (gradients differ in the last bits: XLA and torch sum the matmuls and
# convolutions in different orders).
TOL = dict(atol=1e-6, rtol=1e-6)
# Final accuracy after 30 rounds: both packages run the same cohorts from
# the same initial weights and draw the same minibatches (the port's
# threefry equals the reference's), so only the last bits of their
# gradients differ. The band stays where it was set when the two drew
# from different generators: the reference's own final accuracy over
# sampler seeds 0..4 on these 8 clients spreads by up to 0.226.
RUN_BAND = 0.25
RUN_ROUNDS = 30
ALGOS = ["fedavg", "perfedavg", "pfedme", "ditto", "apfl", "walkman"]


@pytest.fixture(scope="module")
def feds():
    imgs, labels = make_mnist_like(N_SAMPLES, seed=0)
    parts = pathological_split(labels, N_CLIENTS, seed=0)
    r_imgs, r_labels = r_mnist_like(N_SAMPLES, seed=0)
    r_parts = r_split(r_labels, N_CLIENTS, seed=0)
    return (to_device_data(build_federated(imgs, labels, parts), "cpu"),
            r_device(r_build(r_imgs, r_labels, r_parts)))


#: the reduced CNN's dropout activations (NHWC) at BATCH on SHAPE
KEEP_SHAPES = {"mlr": None, "mlp": None,
               "cnn": ((BATCH, 14, 14, 4), (BATCH, 32))}


def _models(kind):
    if kind == "cnn":   # reduced widths: the dropout path at CPU cost
        return (RS.make_cnn(SHAPE, c1=4, c2=8, fc=32),
                CNN(SHAPE, c1=4, c2=8, fc=32))
    return RS.get_model(kind, SHAPE), get_model(kind, SHAPE)


def _trainers(name, kind, feds, **kw):
    data, r_data = feds
    r_model, model = _models(kind)
    ref_cls, cls = RB.REGISTRY[name], TB.REGISTRY[name]
    if name != "walkman":
        kw.setdefault("clients_per_round", len(COHORT))
    return (ref_cls(r_model, r_data, batch_size=BATCH, **kw),
            cls(model, data, batch_size=BATCH, device="cpu", **kw))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ data --
@pytest.mark.parametrize("case", ["synthetic_lr", "mnist_like",
                                  "from_pairs"])
@pytest.mark.parametrize("seed", [0, 3])
def test_data_equals_reference(case, seed):
    if case == "mnist_like":
        got, want = make_mnist_like(150, seed=seed), r_mnist_like(150,
                                                                   seed=seed)
    elif case == "synthetic_lr":
        got = make_synthetic_lr(6, seed=seed)
        want = r_synthetic_lr(6, seed=seed)
        got = [a for pair in got for a in pair]
        want = [a for pair in want for a in pair]
    else:
        fed = build_federated_from_pairs(make_synthetic_lr(5, seed=seed),
                                         seed=seed)
        r_fed = r_from_pairs(r_synthetic_lr(5, seed=seed), seed=seed)
        names = ("x_train", "y_train", "mask_train", "x_test", "y_test",
                 "mask_test")
        got = [getattr(fed, k) for k in names]
        want = [getattr(r_fed, k) for k in names]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------ the reference's draws --
def _ref_draw(key, n_train: int, keep_shapes):
    """What the reference's ``sample_batch`` and the CNN's dropout draw
    from one key: indices ``(B,)`` and, for the CNN (``keep_shapes``:
    its two dropout layers' NHWC activation shapes), the keep masks in
    the port's layout (NCHW for the conv block)."""
    idx = np.asarray(jax.random.randint(key, (BATCH,), 0, n_train))
    if keep_shapes is None:
        return idx, None
    conv, dense = keep_shapes
    k1 = jax.random.bernoulli(jax.random.fold_in(key, 1), 0.75, conv)
    k2 = jax.random.bernoulli(jax.random.fold_in(key, 2), 0.5, dense)
    return idx, (np.asarray(k1).transpose(0, 3, 1, 2), np.asarray(k2))


def _block(keys, clients, n_train, keep_shapes):
    """``keys[c][t]``: client slot c's key of step t → the port's
    ``(idx (T, m, B), keep)`` block."""
    draws = [[_ref_draw(k, int(n_train[c]), keep_shapes) for k in row]
             for c, row in zip(clients, keys)]
    idx = torch.as_tensor(np.stack([[d[0] for d in row] for row in draws],
                                   axis=1), dtype=torch.int64)
    if keep_shapes is None:
        return idx, None
    keep = tuple(torch.as_tensor(np.stack(
        [[d[1][j] for d in row] for row in draws], axis=1))
        for j in range(2))
    return idx, keep


def _steps(key, steps):
    return list(jax.random.split(key, steps))


def ref_draws(name, trainer, key, clients, n_train, keep_shapes):
    """The port's ``round_draws`` for one round, computed from the
    reference's key chain for the same round key."""
    m = len(clients)
    keys = jax.random.split(key, m)

    def block(step_keys):
        return _block(step_keys, clients, n_train, keep_shapes)
    if name in ("fedavg", "apfl"):
        return (block([_steps(k, trainer.local_steps) for k in keys]),)
    if name == "perfedavg":
        return (block([[kk for k in _steps(c, trainer.local_steps)
                        for kk in jax.random.split(k)] for c in keys]),)
    if name == "pfedme":
        return (block([_steps(k, trainer.local_rounds) for k in keys]),)
    assert name == "ditto"
    keys2 = jax.random.split(jax.random.fold_in(key, 7), m)
    local, personal = trainer.local_steps, trainer.personal_steps
    return (block([_steps(k, local) for k in keys]),
            block([_steps(k, personal) for k in keys2]))


def _assert_close(got, want, tol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what,
                               **tol)


# ------------------------------------------------------------ round tier --
def _assert_draws_equal(got, want):
    """Draw blocks ``[(idx, keep)]`` equal, exactly."""
    assert len(got) == len(want)
    for (idx, keep), (w_idx, w_keep) in zip(got, want):
        assert torch.equal(idx, w_idx)
        assert (keep is None) == (w_keep is None)
        for k, w_k in zip(keep or (), w_keep or ()):
            assert torch.equal(k, w_k)


def _one_round(name, ref, port, r_state, state, n_train, keep_shapes,
               own_draws=True):
    """One round in each package from the same state on one round key:
    ``[(leaf, port result, reference result, leading axes)]``. With
    ``own_draws`` the port draws its own batches, held equal to the
    reference's key chain; without, it is handed the key chain's."""
    key = jax.random.PRNGKey(20240611)
    t_key = torch.as_tensor(np.asarray(key).astype(np.int64))
    if name == "walkman":
        i_k = 4
        r_clients, r_y, _ = ref._round_fn(r_state.clients, r_state.y,
                                          jnp.asarray(i_k), key)
        idx, keep = _block([[key]], [i_k], n_train, keep_shapes)
        draws = (idx[0], None if keep is None else tuple(k[0] for k in keep))
        if own_draws:
            own = port.batch_draws(torch.tensor([i_k]), t_key[None])
            _assert_draws_equal([own], [draws])
            draws = own
        new, loss = port._round_impl(state, torch.tensor([i_k]), *draws)
        assert int(new.round) == 1 and np.isfinite(float(loss))
        return [("y", new.y, r_y, 0), ("x", new.clients.x, r_clients.x, 1),
                ("z", new.clients.z, r_clients.z, 1)]
    draws = ref_draws(name, port, key, COHORT, n_train, keep_shapes)
    if own_draws:
        own = port.round_draws(torch.as_tensor(COHORT), t_key)
        _assert_draws_equal(own, draws)
        draws = own
    new = port._round_impl(state, torch.as_tensor(COHORT), draws)
    if name in ("ditto", "apfl"):
        r_w, r_v = ref._round_fn(r_state.w, r_state.v, jnp.asarray(COHORT),
                                 key)
        return [("w", new.w, r_w, 0), ("v", new.v, r_v, 1)]
    return [("w", new.w, ref._round_fn(r_state.w, jnp.asarray(COHORT), key),
             0)]


@pytest.mark.parametrize("kind", ["mlr", "mlp", "cnn"])
@pytest.mark.parametrize("name", ALGOS)
def test_round_matches_reference(name, kind, feds):
    ref, port = _trainers(name, kind, feds)
    r_state = ref.init_state(jax.random.PRNGKey(0))
    state = convert.baseline_state_from_reference(name, _numpy(r_state))
    for leaf, got, want, lead in _one_round(
            name, ref, port, r_state, state, np.asarray(feds[1].n_train),
            KEEP_SHAPES[kind]):
        _assert_close(got, convert._flat_rows(_numpy(want), lead), TOL,
                      leaf)


@pytest.mark.parametrize("kind", ["mlr", "cnn"])
@pytest.mark.parametrize("name,seed", [("perfedavg", 1234), ("pfedme", 99)])
def test_fixed_seed_evaluation(name, seed, kind, feds):
    """The personalized models of the evaluation: the reference's
    adaptation on its fixed-seed keys equals the port's on the same
    batches, and the port's own draws are fixed (every call, any rows)."""
    ref, port = _trainers(name, kind, feds)
    r_state = ref.init_state(jax.random.PRNGKey(2))
    state = convert.baseline_state_from_reference(name, _numpy(r_state))
    want = convert._flat_rows(_numpy(ref.personalized_params(r_state)), 1)
    keys = jax.random.split(jax.random.PRNGKey(seed), N_CLIENTS)
    n_train = np.asarray(feds[1].n_train)
    clients = np.arange(N_CLIENTS)
    idx, keep = _block([[k] for k in keys], clients, n_train,
                       KEEP_SHAPES[kind])
    keep = None if keep is None else tuple(k[0] for k in keep)
    if name == "perfedavg":
        got = port.adapt(state.w, torch.as_tensor(clients), idx[0], keep)
    else:
        got = port.prox_solve(state.w.expand(N_CLIENTS, -1),
                              torch.as_tensor(clients), idx[0], keep)
    _assert_close(got, want, TOL, "personalized")
    every = port.personalized_params(state, slice(None))
    _assert_close(every, want, TOL, "personalized, the port's own draws")
    assert torch.equal(port.personalized_params(state, slice(None)), every)
    # A chunk of rows draws the same batches; the CNN's vmapped
    # convolution over 3 clients may sum in another order than over 8.
    _assert_close(port.personalized_params(state, slice(2, 5)), every[2:5],
                  TOL, "rows 2..4")


def test_ditto_scatter_adds_the_difference(feds):
    """v_all[sel] += v′ − v, bit for bit, which differs from setting v′:
    the personal steps run on fixed large gradients so that v′ is known
    exactly here."""
    _, port = _trainers("ditto", "mlr", feds)
    state = port.init_state(0)
    state.v.add_(torch.randn(state.v.shape,
                             generator=torch.Generator().manual_seed(1)))
    v_before = state.v.clone()
    grads = torch.randn(len(COHORT), port.layout.size,
                        generator=torch.Generator().manual_seed(2)) * 1e3
    port.zone_loss_and_grad = lambda x, clients, idx, keep=None: (
        torch.zeros(len(clients)), grads)
    clients = torch.as_tensor(COHORT)
    new = port._round_impl(state, clients,
                           port.round_draws(clients, port.round_key(5)))
    w, v_sel = port.init_state(0).w.numpy(), v_before[clients].numpy()
    v = v_sel
    for _ in range(port.personal_steps):
        v = v - port.lr * (grads.numpy() + port.lam * (v - w))
    want = v_before.numpy().copy()
    want[COHORT] = v_sel + (v - v_sel)
    assert np.array_equal(new.v.numpy(), want)
    assert not np.array_equal(want[COHORT], v)   # a set would differ


# -------------------------------------------------------------- run tier --
def _recorded_cohorts(trainer):
    """Wrap ``select_clients`` to keep every cohort it returns."""
    cohorts, select = [], trainer.select_clients

    def record(*args):
        cohorts.append(np.asarray(select(*args)).tolist())
        return cohorts[-1]
    trainer.select_clients = record
    return cohorts


@pytest.mark.parametrize("kind", ["mlr", "mlp"])
@pytest.mark.parametrize("name", ALGOS)
def test_run_matches_reference(name, kind, feds):
    kw = {} if name == "walkman" else {"clients_per_round": 4}
    ref, port = _trainers(name, kind, feds, **kw)
    r_init = _numpy(ref.init_state(jax.random.PRNGKey(0)))
    port.init_state = lambda seed: convert.baseline_state_from_reference(
        name, r_init)
    cohorts = (_recorded_cohorts(ref), _recorded_cohorts(port))
    r_res = r_run(ref, rounds=RUN_ROUNDS, eval_every=RUN_ROUNDS, seed=0)
    res = run_simulation(port, rounds=RUN_ROUNDS, eval_every=RUN_ROUNDS,
                         seed=0)
    validate_round_metrics(res.round_metrics)
    for key in ("comm_bytes", "client"):
        assert [m.get(key) for m in res.round_metrics] == \
            [m.get(key) for m in r_res.round_metrics], key
    assert cohorts[0] == cohorts[1]
    assert len(cohorts[1]) == (0 if name == "walkman" else RUN_ROUNDS)
    assert res.total_comm_bytes == r_res.total_comm_bytes
    assert abs(res.final["acc"] - r_res.final["acc"]) <= RUN_BAND, (
        res.final, r_res.final)


# ---------------------------------------------------- refused arguments --
@pytest.mark.parametrize("arg,item", [("mesh", "item 8.7")])
@pytest.mark.parametrize("name", ALGOS)
def test_unported_arguments_are_refused(name, arg, item, feds):
    model = get_model("mlr", SHAPE)
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        TB.REGISTRY[name](model, feds[0], device="cpu", **{arg: object()})
    with pytest.raises(TypeError, match="no_such_argument"):
        TB.REGISTRY[name](model, feds[0], device="cpu", no_such_argument=1)


@pytest.mark.parametrize("name", ALGOS)
def test_lazy_plane_data_is_refused(name):
    """A client data factory (the lazy plane): FedAvg, Per-FedAvg and
    pFedMe take it and run a round on the store; Ditto, APFL and Walkman
    keep dense per-client stacks and refuse it, as the reference does."""
    from repro_torch.data import factory_from_federated

    imgs, labels = make_mnist_like(N_SAMPLES, seed=0)
    factory = factory_from_federated(build_federated(
        imgs, labels, pathological_split(labels, N_CLIENTS, seed=0)))
    cls = TB.REGISTRY[name]
    if not cls.lazy_capable:
        assert not RB.REGISTRY[name].lazy_capable
        with pytest.raises(NotImplementedError,
                           match="client_plane='lazy'"):
            cls(get_model("mlr", SHAPE), factory, device="cpu")
        return
    tr = cls(get_model("mlr", SHAPE), factory, device="cpu",
             store_capacity=N_CLIENTS, clients_per_round=4, batch_size=BATCH)
    state, m = tr.round(tr.init_state(0), 0, np.random.default_rng(0))
    assert tr.client_plane == "lazy" and tr.store.n_resident == 4
    assert m["comm_bytes"] == tr.comm_bytes_per_round(4)
    assert torch.isfinite(state.w).all()


def test_walkman_core_matches_its_equations():
    """``core.walkman``: x, z, the contributions and the y fold, written
    out (the reference's ``client_round``/``y_update`` element for
    element)."""
    gen = torch.Generator().manual_seed(0)
    x, z, y, g = (torch.randn(2, 7, generator=gen) for _ in range(4))
    client, server = walkman.init_states(y[0], 3)
    assert client.x.shape == (3, 7) and not client.x.any()
    assert server.y.shape == (7,) and int(server.round) == 0
    warm, _ = walkman.init_states(y[0], 3, warm=True)
    assert torch.equal(warm.x, y[0].expand(3, -1)) and not warm.z.any()
    new, c_new, c_old = walkman.client_round(
        walkman.WalkmanClientState(x, z), y[0], g, 3.0)
    x_new = y[0] - (g + z) / 3.0
    z_new = z + 3.0 * (x_new - y[0])
    assert torch.equal(new.x, x_new) and torch.equal(new.z, z_new)
    assert torch.equal(c_new, x_new + z_new / 3.0)
    assert torch.equal(c_old, x + z / 3.0)
    assert torch.equal(walkman.y_update(y[0], c_new[0], c_old[0], 5),
                       y[0] + (c_new[0] - c_old[0]) / 5)


# ----------------------------------------------------------------- card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card's cuDNN path)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cohort_gradients_on_card_match_cpu(cuda_device):
    """The baselines' vmapped cohort gradient at the paper's CNN widths
    (P = 1,068,266; 10 clients × batch 20, dropout on) on the card
    against the same call on the CPU, TF32 off: within 1e-5 of the
    largest gradient entry (cuDNN and the CPU sum the convolutions in
    different orders; the H100 reads ~1e-6)."""
    from repro_torch.data.synthetic_images import make_cifar_like

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        imgs, labels = make_cifar_like(1200, seed=1)
        fed = build_federated(imgs, labels,
                              pathological_split(labels, 10, seed=1))
        trainers = {d: TB.FedAvgTrainer(CNN((32, 32, 3)),
                                        to_device_data(fed, d), device=d)
                    for d in ("cpu", cuda_device)}
        w = trainers["cpu"].initial_params(1)
        clients = torch.arange(10)
        idx, keep = trainers["cpu"].batch_draws(
            clients, step_keys(prng.split(prng.prng_key(3), 10), 1))
        grads = {}
        for d, tr in trainers.items():
            _, grads[d] = tr.zone_loss_and_grad(
                w.to(d).expand(10, -1), clients.to(d), idx[0].to(d),
                tuple(k[0].to(d) for k in keep))
        diff = float((grads[cuda_device].cpu() - grads["cpu"]).abs().max())
        scale = float(grads["cpu"].abs().max())
        print(f"cohort gradient, card vs CPU: max abs diff {diff:.3g} of "
              f"max {scale:.3g} ({diff / scale:.3g} relative)")
        assert diff <= 1e-5 * scale
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
