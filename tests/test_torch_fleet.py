"""The port's walker fleet against the JAX package's.

* Control plane (exact): the fleet schedule's columns in both modes,
  chunked across a graph regeneration, the fast zone planner against the
  loop, the eager rounds' host metrics and the fleet hitting time, for
  the same seeds (both packages are numpy on the host).
* Round tier (atol = rtol = 1e-6, the reference kernels' own): the same
  initial params and the same minibatch indices go into the port's fleet
  rounds and into a fleet round assembled from ``repro`` functions, for
  ~6 rounds with a rendezvous inside.
* Port pins: eager ≡ scan bit for bit, scan_fused vs scan at 1e-6, a
  one-walker round-robin fleet ≡ the single-walker trainer bit for bit,
  free-running tokens without a rendezvous, and ``run_simulation`` with
  every engine in both modes.
"""
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import markov as rmarkov
from repro.core import rwsadmm as R
from repro.core import tree as rtree
from repro.core.rwsadmm import RWSADMMHparams as RHP
from repro.data import make_image_dataset as r_images
from repro.data import pathological_split as r_split
from repro.data.loader import build_federated as r_build
from repro.fl.base import to_device_data as r_device
from repro.fl.fleet_trainer import FleetRWSADMMTrainer as RFleet
from repro.fl.fleet_trainer import _rendezvous as r_rendezvous
from repro.kernels.rwsadmm_update.ops import \
    rwsadmm_multizone_fused_update, rwsadmm_zone_fused_update
from repro.models import small as RS
from repro_torch import convert
from repro_torch.core import markov
from repro_torch.core.graph import DynamicGraph
from repro_torch.core.markov import RandomWalkServer
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.data import build_federated, make_image_dataset, \
    pathological_split
from repro_torch.fl import FleetRWSADMMTrainer, RWSADMMTrainer, \
    run_simulation, to_device_data
from repro_torch.fl.base import validate_round_metrics
from repro_torch.models.small import MLP, MLR
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPE, N_CLIENTS, ZONE = (8, 8, 1), 12, 4
ROUNDS = 13                      # chunks (6, 7) cross the regen at round 10
MODES = ("roundrobin", "simultaneous")
TOL = dict(atol=1e-6, rtol=1e-6)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _fed(pkg, seed=0):
    images, split, build = ((r_images, r_split, r_build) if pkg == "ref"
                            else (make_image_dataset, pathological_split,
                                  build_federated))
    imgs, labels = images(500, shape=SHAPE, seed=seed)
    return build(imgs, labels, split(labels, N_CLIENTS, seed=seed),
                 seed=seed)


@pytest.fixture(scope="module")
def port_data():
    return to_device_data(_fed("port"), "cpu")


def _port(data, mode, n_walkers=3, sync_every=4, seed=0, **kw):
    kw.setdefault("solver", "closed_form")
    return FleetRWSADMMTrainer(
        MLR(SHAPE), data, RWSADMMHparams(beta=10.0), n_walkers=n_walkers,
        sync_every=sync_every, fleet_mode=mode, zone_size=ZONE, batch_size=5,
        seed=seed, device="cpu", **kw)


def _ref(mode, n_walkers=3, sync_every=4, seed=0):
    return RFleet(RS.make_mlr(SHAPE), r_device(_fed("ref")), RHP(beta=10.0),
                  n_walkers=n_walkers, sync_every=sync_every,
                  fleet_mode=mode, zone_size=ZONE, batch_size=5,
                  solver="closed_form", scenario=None, seed=seed)


# ----------------------------------------------------------------------
# Control plane (exact)
# ----------------------------------------------------------------------
#: the schedule columns a mode leaves empty
NONE_COLUMNS = {"roundrobin": ("latency_s_walkers", "energy_j_walkers"),
                "simultaneous": ("walker",)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 3])
def test_fleet_schedule_columns_equal(port_data, mode, seed):
    ref, port = _ref(mode, seed=seed), _port(port_data, mode, seed=seed)
    rng_r, rng_p = (np.random.default_rng(seed) for _ in range(2))
    for start, rounds in ((0, 6), (6, 7)):
        sr = ref.schedule(rounds, rng_r, start_round=start)
        sp = port.schedule(rounds, rng_p, start_round=start)
        assert sp.mode == mode
        for col in ("idx", "mask", "n_i", "clients", "active", "walker",
                    "sync", "latency_s", "energy_j", "latency_s_walkers",
                    "energy_j_walkers"):
            a, b = getattr(sr, col), getattr(sp, col)
            if col in NONE_COLUMNS[mode]:
                assert a is None and b is None
                continue
            assert a.dtype == b.dtype and np.array_equal(a, b), col
        assert np.array_equal(np.asarray(sr.keys).astype(np.int64),
                              sp.keys)
        assert sr.sync.any() and sp.rounds == rounds
    for w_r, w_p in zip(ref.walkers, port.walkers):
        assert w_r.history == w_p.history


@pytest.mark.parametrize("n,seed", [(14, 2), (60, 5)],
                         ids=["crowded", "roomy"])
def test_fleet_zone_planner_equals_reference(n, seed):
    """One simultaneous round's K disjoint zones: the port's planner
    gives the reference's plan and consumes the rng alike, on a crowded
    graph (walkers' neighborhoods overlap, later walkers lose clients)
    and a roomy one where only some rounds overlap."""
    dyn = DynamicGraph(n, 4, 9, seed=seed)
    walkers = [RandomWalkServer(seed=60 + 10 * k) for k in range(3)]
    for w in walkers:
        w.reset(dyn.current())
    graph = dyn.current()
    sched = markov.fleet_zone_schedule(dyn, walkers, 30, ZONE,
                                       np.random.default_rng(1),
                                       mode="simultaneous")
    overlaps = 0
    for r, pos in enumerate(sched.clients):
        reach = graph.adjacency[pos].copy()
        reach[np.arange(len(pos)), pos] = True
        overlaps += int((reach.sum(axis=0) > 1).any())
        rng_p, rng_r = (np.random.default_rng(r) for _ in range(2))
        port = markov.plan_fleet_zone_round(graph, pos, ZONE, rng_p)
        ref = rmarkov.plan_fleet_zone_round(graph, pos, ZONE, rng_r)
        for a, b in zip(port, ref):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        assert rng_p.random() == rng_r.random()
    # crowded: every round overlaps; roomy: some rounds do, some don't
    assert overlaps > 0 and (overlaps == len(sched.clients)) == (n == 14)


@pytest.mark.parametrize("mode", MODES)
def test_eager_round_host_metrics_equal(port_data, mode):
    ref, port = _ref(mode, seed=1), _port(port_data, mode, seed=1)
    s_r, s_p = ref.init_state(jax.random.PRNGKey(0)), port.init_state(0)
    rng_r, rng_p = (np.random.default_rng(1) for _ in range(2))
    drop = {"train_loss", "kappa"}
    for r in range(8):
        s_r, m_r = ref.round(s_r, r, rng_r)
        s_p, m_p = port.round(s_p, r, rng_p)
        assert set(m_r) == set(m_p)
        assert ({k: v for k, v in m_r.items() if k not in drop}
                == {k: v for k, v in m_p.items() if k not in drop})
        assert float(m_r["kappa"]) == m_p["kappa"]


@pytest.mark.parametrize("n_walkers", [1, 3])
def test_fleet_hitting_time_equal(port_data, n_walkers):
    ref = _ref("simultaneous", n_walkers)
    port = _port(port_data, "simultaneous", n_walkers)
    ref.schedule(60, np.random.default_rng(0))
    port.schedule(60, np.random.default_rng(0))
    assert port.fleet_hitting_time() is not None
    assert ref.fleet_hitting_time() == port.fleet_hitting_time()


# ----------------------------------------------------------------------
# Round tier (1e-6 against rounds assembled from ``repro`` functions)
# ----------------------------------------------------------------------
HP_ROUND = dict(beta=10.0, kappa=0.01, epsilon=1e-3)
N_ROUND = 10


class JaxFleetReference:
    """Fleet rounds built from ``repro`` functions on the dense plane:
    value and grad of the model's loss at the injected batches, the
    zone / multi-zone update through the Pallas kernel (interpret mode)
    or the jnp oracle, the masked scatter-back and the rendezvous."""

    def __init__(self, fed, params, n_walkers, fused):
        self.model = RS.make_mlp(SHAPE, hidden=16)
        self.template = params
        self.hp = R.RWSADMMHparams(**HP_ROUND)
        self.fused = fused
        self.x_train, self.y_train = fed.x_train, fed.y_train
        flat = rtree.flatten(params)
        self.X = jnp.tile(flat[None], (N_ROUND, 1))
        self.Z = jnp.zeros_like(self.X)
        self.tokens = jnp.tile(flat[None], (n_walkers, 1))
        self.kappa = jnp.float32(HP_ROUND["kappa"])

        def loss(f, xb, yb):
            p = rtree.unflatten(self.template, f)
            return RS.cross_entropy(self.model.apply(p, xb, train=False), yb)

        self.vg = jax.vmap(jax.value_and_grad(loss))

    def _grads(self, x, idx, bidx):
        _, g = self.vg(x, self.x_train[idx[:, None], bidx],
                       self.y_train[idx[:, None], bidx])
        return g

    def _scatter(self, idx, mask, ax, az, xn, zn):
        m = mask[:, None]
        self.X = self.X.at[idx].add(m * (xn - ax))
        self.Z = self.Z.at[idx].add(m * (zn - az))
        self.kappa = self.kappa * self.hp.kappa_decay

    def roundrobin(self, idx, mask, a, bidx, sync):
        hp, y = self.hp, self.tokens[a]
        ax, az = self.X[idx], self.Z[idx]
        g = self._grads(ax, idx, bidx)
        if self.fused:
            xn, zn, yn = rwsadmm_zone_fused_update(
                ax, az, y, g, mask, self.kappa, beta=hp.beta,
                eps_half=hp.eps_half, n_total=float(N_ROUND))
        else:
            new, yn = R.zone_round_masked(R.ClientState(x=ax, z=az), y, g,
                                          mask, hp, self.kappa,
                                          float(N_ROUND))
            xn, zn = new.x, new.z
        self._scatter(idx, mask, ax, az, xn, zn)
        self.tokens = r_rendezvous(self.tokens.at[a].set(yn),
                                   jnp.float32(sync))

    def simultaneous(self, idx, mask, bidx, sync):
        hp = self.hp
        k_walkers, zone = idx.shape
        idx_f, m_f = idx.reshape(-1), mask.reshape(-1)
        ax, az = self.X[idx_f], self.Z[idx_f]
        g = self._grads(ax, idx_f, bidx)
        shp = (k_walkers, zone, -1)
        if self.fused:
            xn, zn, yn = rwsadmm_multizone_fused_update(
                ax.reshape(shp), az.reshape(shp), self.tokens, g.reshape(shp),
                mask, self.kappa, beta=hp.beta, eps_half=hp.eps_half,
                n_total=float(N_ROUND))
        else:
            new, yn = R.multizone_round_masked(
                R.ClientState(x=ax.reshape(shp), z=az.reshape(shp)),
                self.tokens, g.reshape(shp), mask, hp, self.kappa,
                float(N_ROUND))
            xn, zn = new.x, new.z
        self._scatter(idx_f, m_f, ax, az, xn.reshape(ax.shape),
                      zn.reshape(az.shape))
        self.tokens = r_rendezvous(yn, jnp.float32(sync))


@pytest.fixture(scope="module")
def round_fed():
    imgs, labels = make_image_dataset(400, shape=SHAPE, seed=0)
    return build_federated(imgs, labels,
                           pathological_split(labels, N_ROUND, seed=0))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fused", [False, True])
def test_fleet_trajectory_matches_jax_reference(round_fed, mode, fused):
    params = jax.tree_util.tree_map(
        np.asarray, RS.make_mlp(SHAPE, hidden=16).init(jax.random.PRNGKey(0)))
    port = FleetRWSADMMTrainer(
        MLP(SHAPE, hidden=16), to_device_data(round_fed, "cpu"),
        RWSADMMHparams(**HP_ROUND), n_walkers=3, sync_every=3,
        fleet_mode=mode, zone_size=ZONE, batch_size=6, solver="closed_form",
        min_degree=1, seed=0, device="cpu")      # min_degree 1: padding
    state = port.init_state(params=convert.flat_from_reference(params,
                                                               port.layout))
    ref = JaxFleetReference(round_fed, params, 3, fused)
    sched = port.schedule(6, np.random.default_rng(0))
    assert sched.sync.sum() == 2 and (sched.mask == 0).any()
    for r in range(sched.rounds):
        idx = torch.as_tensor(sched.idx[r], dtype=torch.int64)
        mask = torch.as_tensor(sched.mask[r])
        sync = torch.tensor(sched.sync[r])
        key = torch.as_tensor(sched.keys[r])
        bidx, _ = port.zone_batch_indices(idx.reshape(-1), key)
        if mode == "roundrobin":
            a = int(sched.walker[r])
            state, _ = port._rr_step(state, idx, mask, torch.tensor(a), sync,
                                     key, use_fused=fused, batch_idx=bidx)
            ref.roundrobin(sched.idx[r], sched.mask[r], a, bidx.numpy(),
                           sched.sync[r])
        else:
            state, _ = port._sim_step(state, idx, mask, sync, key,
                                      use_fused=fused, batch_idx=bidx)
            ref.simultaneous(sched.idx[r], sched.mask[r], bidx.numpy(),
                             sched.sync[r])
        np.testing.assert_allclose(state.base.clients.x.numpy(), ref.X, **TOL)
        np.testing.assert_allclose(state.base.clients.z.numpy(), ref.Z, **TOL)
        np.testing.assert_allclose(state.tokens.numpy(), ref.tokens, **TOL)
        assert float(state.base.server.kappa) == float(ref.kappa)
    live = sched.idx[sched.mask > 0]
    assert bool(state.base.visited[live].all())


# ----------------------------------------------------------------------
# Port pins
# ----------------------------------------------------------------------
def _run_eager(trainer, rounds=ROUNDS, seed=0):
    rng = np.random.default_rng(seed)
    state, metrics = trainer.init_state(seed), []
    for r in range(rounds):
        state, m = trainer.round(state, r, rng)
        metrics.append(m)
    return state, metrics


def _run_scan(trainer, engine, chunks=(6, 7), seed=0):
    rng = np.random.default_rng(seed)
    state, metrics, r = trainer.init_state(seed), [], 0
    for n in chunks:
        sched = trainer.schedule(n, rng, start_round=r)
        state, stacked = trainer.run_chunk(state, sched, engine)
        metrics += trainer.chunk_round_metrics(sched, stacked, r)
        r += n
    return state, metrics


def _leaves(state):
    return (state.base.clients.x, state.base.clients.z, state.tokens,
            state.base.server.y, state.base.server.kappa,
            state.base.visited)


@pytest.mark.parametrize("n_walkers", [1, 3, 5])
@pytest.mark.parametrize("mode", MODES)
def test_fleet_eager_equals_scan_bitwise(port_data, mode, n_walkers):
    s_e, m_e = _run_eager(_port(port_data, mode, n_walkers))
    s_s, m_s = _run_scan(_port(port_data, mode, n_walkers), "scan")
    assert m_e == m_s
    for a, b in zip(_leaves(s_e), _leaves(s_s)):
        assert torch.equal(a, b)
    assert int(s_s.base.server.round) == ROUNDS


@pytest.mark.parametrize("mode", MODES)
def test_fleet_scan_fused_matches_scan(port_data, mode):
    s_s, m_s = _run_scan(_port(port_data, mode), "scan")
    s_f, m_f = _run_scan(_port(port_data, mode), "scan_fused")
    for a, b in zip(_leaves(s_s)[:4], _leaves(s_f)[:4]):
        torch.testing.assert_close(a, b, **TOL)
    assert torch.equal(s_s.base.visited, s_f.base.visited)
    np.testing.assert_allclose([m["train_loss"] for m in m_s],
                               [m["train_loss"] for m in m_f], **TOL)


def test_single_walker_fleet_matches_single_trainer(port_data):
    """n_walkers = 1 round-robin is the single-walker trajectory bit for
    bit: walker 0 reuses the walker seed (seed + 1), the same zones and
    the same round seeds."""
    single = RWSADMMTrainer(MLR(SHAPE), port_data, RWSADMMHparams(beta=10.0),
                            zone_size=ZONE, batch_size=5,
                            solver="closed_form", seed=0, device="cpu")
    fleet = _port(port_data, "roundrobin", n_walkers=1, sync_every=10**9)
    s_s, m_s = _run_eager(single, rounds=15)
    s_f, m_f = _run_eager(fleet, rounds=15)
    for a, b in zip(m_s, m_f):
        assert a == {k: v for k, v in b.items() if k != "walker"}
    assert torch.equal(s_s.clients.x, s_f.base.clients.x)
    assert torch.equal(s_s.clients.z, s_f.base.clients.z)
    assert torch.equal(s_s.server.y, s_f.tokens[0])
    assert torch.equal(s_s.visited, s_f.base.visited)


@pytest.mark.parametrize("mode", MODES)
def test_sync_every_beyond_run_keeps_tokens_independent(port_data, mode):
    s_a, _ = _run_eager(_port(port_data, mode, sync_every=10**9))
    s_b, _ = _run_eager(_port(port_data, mode, sync_every=ROUNDS + 5))
    s_c, _ = _run_eager(_port(port_data, mode, sync_every=5))
    assert torch.equal(s_a.tokens, s_b.tokens)
    assert not torch.allclose(s_a.tokens[0], s_a.tokens[1])
    assert not torch.allclose(s_a.tokens, s_c.tokens)
    # A rendezvous leaves every walker holding the same token.
    s_d, _ = _run_eager(_port(port_data, mode, sync_every=ROUNDS))
    assert all(torch.equal(s_d.tokens[0], t) for t in s_d.tokens)


@pytest.mark.parametrize("mode", MODES)
def test_run_simulation_every_engine(port_data, mode):
    results = {engine: run_simulation(_port(port_data, mode), rounds=7,
                                      eval_every=3, seed=1, engine=engine)
               for engine in ("eager", "scan", "scan_fused")}
    keys = {e: validate_round_metrics(r.round_metrics)
            for e, r in results.items()}
    assert keys["eager"] == keys["scan"] == keys["scan_fused"]
    assert ("walker" in keys["eager"]) == (mode == "roundrobin")
    assert ("clients" in keys["eager"]) == (mode == "simultaneous")
    assert results["eager"].round_metrics == results["scan"].round_metrics
    assert results["eager"].history == results["scan"].history
    assert [h["round"] for h in results["scan_fused"].history] == [3, 6, 7]
    for h in results["scan_fused"].history:
        assert 0.0 <= h["acc_personalized"] <= 1.0


def test_unvisited_clients_evaluate_the_fleet_mean_token(port_data):
    trainer = _port(port_data, "simultaneous", n_walkers=2)
    state, _ = _run_eager(trainer, rounds=1)
    pers = trainer.personalized_params(state)
    mean = trainer.global_params(state)
    torch.testing.assert_close(mean, state.tokens.mean(dim=0), **TOL)
    assert not torch.equal(state.tokens[0], state.tokens[1])
    for i in range(N_CLIENTS):
        want = state.base.clients.x[i] if state.base.visited[i] else mean
        assert torch.equal(pers[i], want)
    assert not bool(state.base.visited.all())


def test_fleet_rejects_unsupported_settings(port_data):
    with pytest.raises(ValueError, match="closed_form"):
        _port(port_data, "simultaneous", solver="prox_sgd")
    with pytest.raises(ValueError, match="fleet_mode"):
        _port(port_data, "convoy")
    # Scenarios are ported: field_trial is taken, and its environment
    # (Gauss-Markov mobility, lossy links, churn) drives the fleet.
    fleet = _port(port_data, "roundrobin", scenario="field_trial")
    assert fleet.scenario.cfg.name == "field_trial"
    assert fleet.dyn_graph is fleet.scenario
    assert fleet.scenario.link is not None and fleet.scenario.churn is not None
    with pytest.raises(TypeError, match="no_such_argument"):
        _port(port_data, "roundrobin", no_such_argument=1)


def test_fleet_imports_with_jax_and_reference_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.fl\n"
            "from repro_torch.fl import FleetRWSADMMTrainer\n"
            "from repro_torch.kernels.rwsadmm_update.ops import "
            "multizone_fused_update, fused_update\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
