"""The port's lazy client plane ≡ its dense plane bit for bit, and its
lazy runs against the reference's.

A trainer built on a ``ClientDataFactory`` keeps clients in the bounded
LRU store (``repro_torch.fl.client_store``), indexed by slot. On the CPU
it reproduces the dense run exactly: the same init rows, the same gather
and scatter arithmetic on the same values, exact fp32 round trips on
evict and restore. Held here on every engine (``scan_fused`` through the
zone kernels' plain versions), for the single walker, both fleet modes
and the FedAvg family, with evictions inside the runs; then the factory's
rows and a lazy run against the reference's (host columns by ``==``,
x/z/y at 1e-6), the resident-set evaluation and the guards.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.baselines import REGISTRY
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.data import build_federated, factory_from_federated, \
    make_image_dataset, pathological_split, synthetic_lr_factory
from repro_torch.fl.base import to_device_data
from repro_torch.fl.client_store import PREFETCH_COUNTERS, STORE_COUNTERS
from repro_torch.fl.fleet_trainer import FleetRWSADMMTrainer
from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer
from repro_torch.fl.simulation import run_simulation
from repro_torch.models.small import get_model
from repro_torch.scenarios import get_scenario_config
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 16
SHAPE = (8, 8, 1)
HP = dict(beta=10.0, kappa=0.01, epsilon=1e-3)
TOL = dict(atol=1e-6, rtol=1e-6)
#: a window of 2 rounds visits at most 2·3 + 1 (padding id 0) clients
WINDOW, ZONE, CAPACITY, EAGER_CAPACITY = 2, 3, 8, 5


def _fed(build, images, split):
    imgs, labels = images(480, shape=SHAPE, seed=0)
    return build(imgs, labels, split(labels, N, seed=0), seed=0)


@pytest.fixture(scope="module")
def fed():
    f = _fed(build_federated, make_image_dataset, pathological_split)
    return to_device_data(f, "cpu"), factory_from_federated(f), f


def _scenario(backend="dense"):
    return dataclasses.replace(get_scenario_config("lossy_links"),
                               graph_backend=backend, neighbor_k_max=8)


def _make(fed, *, lazy, fleet=0, mode="roundrobin", capacity=CAPACITY,
          prefetch=False, kind="mlr", **extra):
    dense, factory, _ = fed
    kw = dict(zone_size=ZONE, batch_size=6, solver="closed_form",
              scenario=_scenario(), seed=0, device="cpu", **extra)
    if lazy:
        kw.update(store_capacity=capacity, prefetch=prefetch)
    data = factory if lazy else dense
    model = get_model(kind, SHAPE)
    if fleet:
        return FleetRWSADMMTrainer(model, data, RWSADMMHparams(**HP),
                                   n_walkers=fleet, sync_every=3,
                                   fleet_mode=mode, **kw)
    return RWSADMMTrainer(model, data, RWSADMMHparams(**HP), **kw)


def _run(tr, *, engine, rounds=8, eval_every=WINDOW):
    return run_simulation(tr, rounds=rounds, eval_every=eval_every, seed=0,
                          engine=engine)


def _materialize_all(tr, state) -> list[np.ndarray]:
    """The lazy run's client rows in dense ``(n, P)`` order: resident
    slots, the spill buffer, and the template for clients never seen."""
    store = tr.store
    leaves = [t.numpy() for t in tr._state_clients(state)]
    tmpl = [t.numpy() for t in store._template]
    rows = []
    for i in range(tr.n_clients):
        s = int(store.slot_arr[i])
        rows.append([leaf[s] for leaf in leaves] if s >= 0
                    else store._spill.get(i, tmpl))
    return [np.stack([r[j] for r in rows]) for j in range(len(leaves))]


def _assert_states_equal(dense_tr, sd, lazy_tr, sl):
    base_d, base_l = getattr(sd, "base", sd), getattr(sl, "base", sl)
    for got, want in zip(_materialize_all(lazy_tr, sl),
                         (base_d.clients.x, base_d.clients.z)):
        np.testing.assert_array_equal(got, want.numpy())
    for a, b in zip(base_l.server, base_d.server):
        assert torch.equal(a, b)
    assert torch.equal(base_l.visited, base_d.visited)
    if hasattr(sd, "tokens"):
        assert torch.equal(sl.tokens, sd.tokens)


# --------------------------------------------------------- lazy ≡ dense --
#: (engine, walkers, fleet mode, capacity): each capacity below n yet at
#: least the largest working set one ensure takes (a round's zone(s), or
#: a window's, plus the padding id)
ENGINE_CASES = [("eager", 0, None, 5), ("eager", 3, "roundrobin", 5),
                ("eager", 3, "simultaneous", 10), ("scan", 0, None, 8),
                ("scan", 3, "roundrobin", 8), ("scan_fused", 0, None, 8),
                ("scan_fused", 2, "roundrobin", 8),
                ("scan_fused", 2, "simultaneous", 13)]


@pytest.mark.parametrize("engine,fleet,mode,cap", ENGINE_CASES)
def test_lazy_matches_dense_with_evictions(fed, engine, fleet, mode, cap):
    """Every round metric, eval snapshot and the final state (resident,
    spilled and template rows reassembled) equal the dense run's, with
    evictions and restores inside the run."""
    mode = mode or "roundrobin"
    dense_tr = _make(fed, lazy=False, fleet=fleet, mode=mode)
    lazy_tr = _make(fed, lazy=True, fleet=fleet, mode=mode, capacity=cap)
    states = {}
    for tr in (dense_tr, lazy_tr):
        init = tr.init_state

        def keep(seed, _init=init, _tr=tr):
            states[_tr] = _init(seed)
            return states[_tr]
        tr.init_state = keep
    rd = _run(dense_tr, engine=engine, rounds=10)
    rl = _run(lazy_tr, engine=engine, rounds=10)
    assert lazy_tr.store.counters["evictions"] > 0
    assert lazy_tr.store.counters["restores"] > 0
    assert rd.round_metrics == rl.round_metrics
    assert [h["round"] for h in rd.history] == \
        [h["round"] for h in rl.history]
    assert rd.total_comm_bytes == rl.total_comm_bytes
    _assert_states_equal(dense_tr, states[dense_tr], lazy_tr,
                         states[lazy_tr])


@pytest.mark.parametrize("fleet", [0, 3])
def test_prefetch_on_matches_off_bit_identical(fed, fleet):
    """The prefetch pipeline moves no number: metrics, eval history and
    the base counters equal the run without it, and it staged rows."""
    t0 = _make(fed, lazy=True, fleet=fleet)
    r0 = _run(t0, engine="scan", rounds=10)
    t1 = _make(fed, lazy=True, fleet=fleet, prefetch=True)
    r1 = _run(t1, engine="scan", rounds=10)
    assert r0.round_metrics == r1.round_metrics
    assert r0.history == r1.history
    assert {k: t1.store.counters[k] for k in STORE_COUNTERS} == \
        t0.store.counters
    assert set(t1.store.counters) == set(STORE_COUNTERS + PREFETCH_COUNTERS)
    assert t1.store.counters["prefetch_hits"] > 0


@pytest.mark.parametrize("name", ["fedavg", "perfedavg", "pfedme"])
def test_cohort_lazy_matches_dense(fed, name):
    """The FedAvg family on the store (cohort rows by slot, evictions
    between rounds): the global model equals the dense run's bit for bit
    round by round, the round metrics by ``==``; with every client
    resident in its own slot the evaluation agrees to summation order."""
    dense, factory, _ = fed
    model = get_model("mlr", SHAPE)
    kw = dict(clients_per_round=4, batch_size=6, device="cpu")
    kw.update({"fedavg": dict(local_steps=2),
               "perfedavg": dict(local_steps=2),
               "pfedme": dict(inner_steps=2, local_rounds=2)}[name])
    td = REGISTRY[name](model, dense, **kw)
    tl = REGISTRY[name](model, factory, store_capacity=6, **kw)
    rngd, rngl = np.random.default_rng(0), np.random.default_rng(0)
    sd, sl = td.init_state(0), tl.init_state(0)
    for r in range(6):
        sd, md = td.round(sd, r, rngd)
        sl, ml = tl.round(sl, r, rngl)
        assert md == ml
        assert torch.equal(sd.w, sl.w), r
    assert tl.store.counters["evictions"] > 0
    # Every client resident, client i in slot i (a fresh store hands out
    # slots in order), so the slot-keyed personalization draws what the
    # dense evaluation draws for each client.
    full = REGISTRY[name](model, factory, store_capacity=N, **kw)
    sf = full.init_state(0)
    full._ensure_round(sf, np.arange(N))
    assert full.store.gid_of.tolist() == list(range(N))
    ed, el = td.evaluate(sd), full.evaluate(sd)
    assert el["eval_clients"] == N
    for key in ed:
        np.testing.assert_allclose(el[key], ed[key], rtol=1e-5, atol=1e-6)


def test_lazy_eval_full_residency_matches_dense(fed):
    """With capacity n every visited client stays resident, so the
    resident-set metrics cover the population once all are visited."""
    rd = _run(_make(fed, lazy=False), engine="eager", rounds=12,
              eval_every=12)
    tl = _make(fed, lazy=True, capacity=N)
    rl = _run(tl, engine="eager", rounds=12, eval_every=12)
    n_res = rl.final["eval_clients"]
    assert n_res == tl.store.n_resident
    if n_res == N:
        for key in ("acc_global", "loss_global", "acc_personalized",
                    "loss_personalized"):
            np.testing.assert_allclose(rl.final[key], rd.final[key],
                                       rtol=1e-5, atol=1e-6)


def test_lazy_eval_is_the_resident_clients_dense_eval(fed):
    """The resident-set evaluation averages exactly the resident
    clients' dense per-client numbers (the global model and the
    personalized rows: x for visited clients, y for the rest)."""
    dense_tr = _make(fed, lazy=False)
    lazy_tr = _make(fed, lazy=True, capacity=EAGER_CAPACITY)
    rng, rng2 = np.random.default_rng(0), np.random.default_rng(0)
    sd, sl = dense_tr.init_state(0), lazy_tr.init_state(0)
    for r in range(7):
        sd, _ = dense_tr.round(sd, r, rng)
        sl, _ = lazy_tr.round(sl, r, rng2)
    out = lazy_tr.evaluate(sl)
    ids = lazy_tr.store.gid_of[lazy_tr.store.gid_of >= 0]
    d = dense_tr.data
    cols = (d.x_test[ids], d.y_test[ids], d.mask_test[ids])
    acc, loss = dense_tr._eval_stacked(dense_tr.layout.views(
        dense_tr.personalized_params(sd)[ids]), *cols)
    np.testing.assert_allclose(out["acc_personalized"],
                               acc.numpy().mean(), rtol=1e-6)
    np.testing.assert_allclose(out["loss_personalized"],
                               loss.numpy().mean(), rtol=1e-6)
    acc_g, _ = dense_tr._eval_shared(dense_tr.layout.views(
        dense_tr.global_params(sd)), *cols)
    np.testing.assert_allclose(out["acc_global"], acc_g.numpy().mean(),
                               rtol=1e-6)
    assert out["eval_clients"] == len(ids) == EAGER_CAPACITY


def test_factory_rows_match_dense_stack(fed):
    """``factory_from_federated`` gives the rows ``to_device_data``
    stacks, padding included."""
    dense, factory, _ = fed
    for got, want in zip(factory.rows(np.arange(N)), dense):
        np.testing.assert_array_equal(got, want.numpy())


def test_factory_rows_equal_the_reference(fed):
    """Both factories' rows equal the reference's byte for byte: the
    wrapped stack and the per-client-seeded Synthetic(α, β)."""
    from repro.data import factory_from_federated as r_wrap
    from repro.data import make_image_dataset as r_images
    from repro.data import pathological_split as r_split
    from repro.data import synthetic_lr_factory as r_synth
    from repro.data.loader import build_federated as r_build

    r_fac = r_wrap(_fed(r_build, r_images, r_split))
    ids = np.array([3, 0, 15, 7, 7])
    for got, want in zip(fed[1].rows(ids), r_fac.rows(ids)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    kw = dict(n_clients=50, seed=3, n_features=60, min_samples=20,
              mean_samples=2.0)
    port, ref = synthetic_lr_factory(**kw), r_synth(**kw)
    assert (port.max_train, port.max_test, port.feature_shape) == \
        (ref.max_train, ref.max_test, ref.feature_shape)
    ids = np.array([49, 0, 17, 17, 33])
    for got, want in zip(port.rows(ids), ref.rows(ids)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# ----------------------------------------------------- against repro --
@pytest.mark.parametrize("fleet", [0, 3])
def test_lazy_run_follows_the_reference_lazy_run(fed, fleet):
    """Eight eager rounds of both packages on the lazy plane from the
    same weights, capacity 5 (evictions and restores in both): the same
    host columns, slot maps and store counters by ``==``, and x/z/y
    (resident and spilled rows) within 1e-6."""
    from repro.core.rwsadmm import RWSADMMHparams as RHP
    from repro.data import factory_from_federated as r_wrap
    from repro.data import make_image_dataset as r_images
    from repro.data import pathological_split as r_split
    from repro.data.loader import build_federated as r_build
    from repro.fl.fleet_trainer import FleetRWSADMMTrainer as RFleet
    from repro.fl.rwsadmm_trainer import RWSADMMTrainer as RTrainer
    from repro.models import small as RS

    r_fac = r_wrap(_fed(r_build, r_images, r_split))
    kw = dict(zone_size=ZONE, batch_size=6, solver="closed_form",
              scenario=_scenario(), seed=0, store_capacity=EAGER_CAPACITY)
    if fleet:
        kw.update(n_walkers=fleet, sync_every=3)
        ref = RFleet(RS.make_mlr(SHAPE), r_fac, RHP(**HP), **kw)
    else:
        ref = RTrainer(RS.make_mlr(SHAPE), r_fac, RHP(**HP), **kw)
    port = _make(fed, lazy=True, fleet=fleet, capacity=EAGER_CAPACITY)
    r_state = ref.init_state(jax.random.PRNGKey(0))
    r_base = r_state.base if fleet else r_state
    state = port.init_state(params=convert._flat_rows(
        jax.tree_util.tree_map(np.asarray, r_base.server.y), 0))
    r_rng, rng = np.random.default_rng(0), np.random.default_rng(0)
    for r in range(8):
        r_state, r_m = ref.round(r_state, r, r_rng)
        state, m = port.round(state, r, rng)
        host = {k: v for k, v in m.items() if k != "train_loss"}
        assert host == {k: v for k, v in r_m.items() if k in host}, r
        np.testing.assert_allclose(m["train_loss"], r_m["train_loss"],
                                   **TOL)
    assert port.store.counters == ref.store.counters
    assert port.store.counters["restores"] > 0
    assert port.store.spilled_ids.tolist() == ref.store.spilled_ids.tolist()
    np.testing.assert_array_equal(port.store.gid_of, ref.store.gid_of)
    r_base, base = (r_state.base, state.base) if fleet else (r_state, state)

    def flat(tree, lead):
        return convert._flat_rows(jax.tree_util.tree_map(np.asarray, tree),
                                  lead).numpy()
    np.testing.assert_allclose(base.clients.x.numpy(),
                               flat(r_base.clients.x, 1), **TOL)
    np.testing.assert_allclose(base.clients.z.numpy(),
                               flat(r_base.clients.z, 1), **TOL)
    np.testing.assert_allclose(base.server.y.numpy(),
                               flat(r_base.server.y, 0), **TOL)
    for i in port.store.spilled_ids.tolist():
        # The reference spills its pytree's leaves in tree order: x's
        # leaves, then z's, each in the flat layout's leaf order.
        np.testing.assert_allclose(
            np.concatenate(port.store._spill[i]),
            np.concatenate([np.asarray(a).reshape(-1)
                            for a in ref.store._spill[i]]), **TOL)
    assert np.array_equal(base.visited.numpy(), np.asarray(r_base.visited))
    if fleet:
        np.testing.assert_allclose(state.tokens.numpy(),
                                   flat(r_state.tokens, 1), **TOL)


# --------------------------------------------------------------- guards --
def test_lazy_guards(fed):
    """Calls that would build (n, P) stacks refuse on the lazy plane, and
    the label-skew walk (which needs every client's labels) with it."""
    tr = _make(fed, lazy=True)
    state = tr.init_state(0)
    with pytest.raises(NotImplementedError, match="lazy"):
        tr.personalized_params(state)
    with pytest.raises(NotImplementedError, match="dense"):
        tr.lyapunov(state, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="lazy plane"):
        _make(fed, lazy=True, walk_policy="label_skew")
    with pytest.raises(TypeError, match="ClientDataFactory"):
        RWSADMMTrainer(get_model("mlr", SHAPE), object(), device="cpu")
    with pytest.raises(ValueError, match="exceeds store capacity"):
        _run(_make(fed, lazy=True, capacity=3), engine="scan")


@pytest.mark.parametrize("name", ["ditto", "apfl", "walkman"])
def test_dense_stack_baselines_refuse_a_factory(fed, name):
    with pytest.raises(NotImplementedError, match="client_plane='lazy'"):
        REGISTRY[name](get_model("mlr", SHAPE), fed[1], device="cpu")
