"""The RWSADMM trainers under the walk policies, against the JAX package.

Round tier: one biased round of each package from the same state on the
same round key and the same importance weight (the schedule's ``iw``,
rounded to fp32 as both engines round it): the draws are the reference's
key tree, and x, z, y agree at the reference tests' atol = rtol = 1e-6
on the unfused fold (``y + iw·Δ``), the fused one (``y₀ + iw·(y₁ − y₀)``
after the zone kernel's plain version against the Pallas kernel in
interpret mode) and prox-SGD; the simultaneous fleet's per-walker
rescale likewise. Run tier: 30 rounds of ``run_simulation`` under each
biased policy from the same initial weights, every host column and every
importance weight equal by ``==``, the losses within ``RUN_LOSS_TOL``.
Then the engines (eager ≡ ``scan`` bit for bit, ``scan_fused`` against
``scan`` at 1e-6), a uniform policy's round untouched by the iw path,
``lyapunov`` at 1e-5 relative, and on the card the captured biased
windows against uncaptured rounds.
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
from repro_torch.core import prng
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.data import build_federated, make_image_dataset, \
    pathological_split
from repro_torch.fl import FleetRWSADMMTrainer, RWSADMMTrainer, \
    run_simulation, to_device_data
from repro_torch.models.small import MLP, MLR
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPE, N_CLIENTS, ZONE, BATCH, STEPS = (8, 8, 1), 12, 4, 6, 3
HP = dict(beta=10.0, kappa=0.01, epsilon=1e-3)
TOL = dict(atol=1e-6, rtol=1e-6)
# 30 eager MLR rounds of both packages from the same weights on the same
# draws and weights: each round's gradients differ in the last bits (XLA
# and torch sum the matmul in other orders) and feed the next, and the
# importance weights (up to 2.2 here) scale those ulps into y. The losses
# read at most 4.8e-7 apart (a few fp32 ulps of losses ~2); held at 1e-5,
# as the unbiased 10-round run in test_torch_keyed_rounds.py.
RUN_LOSS_TOL = 1e-5
HOST_COLUMNS = ("client", "clients", "walker", "zone", "n_i", "comm_bytes",
                "staleness_p50", "staleness_max", "latency_s", "energy_j")


def _fed(pkg):
    images, split, build = ((r_images, r_split, r_build) if pkg == "ref"
                            else (make_image_dataset, pathological_split,
                                  build_federated))
    imgs, labels = images(360, shape=SHAPE, seed=0)
    return build(imgs, labels, split(labels, N_CLIENTS, seed=0), seed=0)


@pytest.fixture(scope="module")
def feds():
    return r_device(_fed("ref")), to_device_data(_fed("port"), "cpu")


def _models(kind):
    if kind == "mlp":
        return RS.make_mlp(SHAPE, hidden=16), MLP(SHAPE, hidden=16)
    return RS.make_mlr(SHAPE), MLR(SHAPE)


def _pair(feds, kind, solver, policy, fleet_mode=None, **extra):
    r_model, model = _models(kind)
    kw = dict(zone_size=ZONE, batch_size=BATCH, solver=solver,
              inner_steps=STEPS, inner_lr=0.05, seed=0, walk_policy=policy,
              walk_bias=0.5, **extra)
    if fleet_mode is not None:
        kw.update(n_walkers=3, sync_every=2, fleet_mode=fleet_mode)
        ref = RFleet(r_model, feds[0], RHP(**HP), **kw)
        port = FleetRWSADMMTrainer(model, feds[1], RWSADMMHparams(**HP),
                                   device="cpu", **kw)
    else:
        ref = RTrainer(r_model, feds[0], RHP(**HP), **kw)
        port = RWSADMMTrainer(model, feds[1], RWSADMMHparams(**HP),
                              device="cpu", **kw)
    r_state = ref.init_state(jax.random.PRNGKey(0))
    y = r_state.base.server.y if fleet_mode else r_state.server.y
    params = convert._flat_rows(jax.tree_util.tree_map(np.asarray, y), 0)
    return ref, port, r_state, port.init_state(params=params)


def _rows(tree, lead):
    return convert._flat_rows(jax.tree_util.tree_map(np.asarray, tree),
                              lead).numpy()


def _assert_state(state, r_state, fleet=False):
    base, r_base = (state.base, r_state.base) if fleet else (state, r_state)
    np.testing.assert_allclose(base.clients.x.numpy(),
                               _rows(r_base.clients.x, 1), **TOL)
    np.testing.assert_allclose(base.clients.z.numpy(),
                               _rows(r_base.clients.z, 1), **TOL)
    if fleet:
        np.testing.assert_allclose(state.tokens.numpy(),
                                   _rows(r_state.tokens, 1), **TOL)
    else:
        np.testing.assert_allclose(base.server.y.numpy(),
                                   _rows(r_base.server.y, 0), **TOL)


# ---------------------------------------------------------- round tier --
@pytest.mark.parametrize("kind,solver,fused,policy", [
    ("mlr", "closed_form", False, "staleness"),
    ("mlp", "closed_form", False, "label_skew"),
    ("mlp", "closed_form", True, "staleness"),
    ("mlr", "closed_form", True, "label_skew"),
    ("mlr", "prox_sgd", False, "staleness"),
    ("mlp", "prox_sgd", False, "label_skew")])
def test_biased_round_follows_the_reference(feds, kind, solver, fused,
                                            policy):
    """Three rounds of ``_round_impl`` in both packages on the reference
    schedule's zones, keys and importance weights (round 0's is the
    reset's 1.0, then they move)."""
    ref, port, r_state, state = _pair(feds, kind, solver, policy)
    r_round = jax.jit(functools.partial(ref._round_impl, use_fused=fused))
    sched = ref.schedule(3, np.random.default_rng(3))
    assert sched.iw is not None and len(set(sched.iw[1:])) > 1
    for r in range(3):
        idx, mask, key = sched.idx[r], sched.mask[r], sched.keys[r]
        r_state, _ = r_round(r_state, jnp.asarray(idx), jnp.asarray(mask),
                             jnp.asarray(float(sched.n_i[r])),
                             jnp.asarray(key),
                             jnp.asarray(sched.iw[r], jnp.float32))
        state, _ = port._round_impl(
            state, torch.as_tensor(idx, dtype=torch.int64),
            torch.as_tensor(mask), torch.as_tensor(key.astype(np.int64)),
            torch.tensor(sched.iw[r], dtype=torch.float32), use_fused=fused)
        _assert_state(state, r_state)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", ["roundrobin", "simultaneous"])
def test_biased_fleet_round_follows_the_reference(feds, mode, fused):
    """Three fleet rounds under ``staleness`` in both packages on the
    reference schedule, with its (R,) or (R, K) weights."""
    ref, port, r_state, state = _pair(feds, "mlp", "closed_form",
                                      "staleness", mode)
    sched = ref.schedule(4, np.random.default_rng(5))
    step_fn = ref._fleet_step_fn(mode, fused)
    for r in range(4):
        idx, mask, key = sched.idx[r], sched.mask[r], sched.keys[r]
        tkey, sync = torch.as_tensor(key.astype(np.int64)), \
            torch.tensor(sched.sync[r])
        t_idx = torch.as_tensor(idx, dtype=torch.int64)
        iw_r = jnp.asarray(sched.iw[r], jnp.float32)
        iw_t = torch.as_tensor(np.asarray(sched.iw[r], np.float32))
        if mode == "roundrobin":
            a = int(sched.walker[r])
            r_state, _ = step_fn(r_state, jnp.asarray(idx),
                                 jnp.asarray(mask),
                                 jnp.asarray(float(sched.n_i[r])),
                                 jnp.asarray(a, jnp.int32),
                                 jnp.asarray(sched.sync[r]),
                                 jnp.asarray(key), iw_r)
            state, _ = port._rr_step(state, t_idx, torch.as_tensor(mask),
                                     torch.tensor(a), sync, tkey, iw_t,
                                     use_fused=fused)
        else:
            r_state, _ = step_fn(r_state, jnp.asarray(idx),
                                 jnp.asarray(mask),
                                 jnp.asarray(sched.n_i[r]),
                                 jnp.asarray(sched.sync[r]),
                                 jnp.asarray(key), iw_r)
            state, _ = port._sim_step(state, t_idx, torch.as_tensor(mask),
                                      sync, tkey, iw_t, use_fused=fused)
        _assert_state(state, r_state, fleet=True)
    if mode == "simultaneous":
        assert sched.iw.shape == (4, 3) and len(set(sched.iw[1:].ravel())) > 1


# ------------------------------------------------------------ run tier --
def _host(metrics):
    return {k: [m.get(k) for m in metrics] for k in HOST_COLUMNS}


@pytest.mark.parametrize("fleet", [None, "simultaneous"])
@pytest.mark.parametrize("policy", ["staleness", "label_skew"])
def test_biased_run_follows_the_reference(feds, policy, fleet):
    """30 eager rounds through ``run_simulation`` in both packages from
    the same weights: host columns and every walker's importance weights
    by ``==``, losses within ``RUN_LOSS_TOL``."""
    ref, port, _, state = _pair(feds, "mlr", "closed_form", policy, fleet)
    port.init_state = lambda seed: state
    r_res = r_run(ref, rounds=30, eval_every=30, seed=0)
    res = run_simulation(port, rounds=30, eval_every=30, seed=0)
    assert _host(res.round_metrics) == _host(r_res.round_metrics)
    walkers = (port.walkers, ref.walkers) if fleet else ([port.walker],
                                                         [ref.walker])
    for w_t, w_r in zip(*walkers):
        assert w_t.weight_history == w_r.weight_history
        assert w_t.history == w_r.history
        assert len(set(w_t.weight_history)) > 2
    np.testing.assert_allclose([m["train_loss"] for m in res.round_metrics],
                               [m["train_loss"] for m in r_res.round_metrics],
                               atol=RUN_LOSS_TOL, rtol=RUN_LOSS_TOL)


# ------------------------------------------------------------- engines --
def _leaves(state):
    base = getattr(state, "base", state)
    out = [base.clients.x, base.clients.z, base.server.y, base.server.kappa,
           base.visited]
    return out + ([state.tokens] if base is not state else [])


@pytest.mark.parametrize("fleet", [None, "roundrobin", "simultaneous"])
@pytest.mark.parametrize("policy", ["staleness", "label_skew"])
def test_engines_agree_under_a_biased_walk(feds, policy, fleet):
    """Eager ≡ ``scan`` bit for bit over two windows, ``scan_fused``
    against ``scan`` at 1e-6, with every run's host columns equal."""
    runs = {}
    for engine in ("eager", "scan", "scan_fused"):
        _, port, _, _ = _pair(feds, "mlp", "closed_form", policy, fleet)
        runs[engine] = run_simulation(port, rounds=8, eval_every=4, seed=1,
                                      engine=engine)
    assert _host(runs["eager"].round_metrics) == \
        _host(runs["scan"].round_metrics) == \
        _host(runs["scan_fused"].round_metrics)
    e, s, f = ([m["train_loss"] for m in runs[k].round_metrics]
               for k in ("eager", "scan", "scan_fused"))
    assert e == s
    np.testing.assert_allclose(f, s, **TOL)
    assert runs["eager"].final == runs["scan"].final


@pytest.mark.parametrize("fleet", [None, "simultaneous"])
def test_engine_states_under_a_biased_walk(feds, fleet):
    """The states themselves: eager and ``scan`` bit for bit,
    ``scan_fused`` at 1e-6, after two 4-round windows."""
    out = {}
    for engine in ("eager", "scan", "scan_fused"):
        _, port, _, state = _pair(feds, "mlp", "closed_form", "staleness",
                                  fleet)
        rng = np.random.default_rng(2)
        for start in (0, 4):
            if engine == "eager":
                for r in range(start, start + 4):
                    state, _ = port.round(state, r, rng)
            else:
                state, _ = port.run_chunk(
                    state, port.schedule(4, rng, start_round=start), engine)
        out[engine] = _leaves(state)
    assert all(torch.equal(a, b) for a, b in zip(out["eager"], out["scan"]))
    for a, b in zip(out["scan"], out["scan_fused"]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_uniform_policy_round_is_untouched(feds):
    """``degree`` and ``metropolis`` run no iw op: their schedules carry
    no ``iw``, no window column holds one, and neither the eager nor the
    scan rounds pass one to ``_round_impl``; an explicit ``degree``
    policy runs the default trainer's rounds bit for bit."""
    passed, states = [], {}
    for policy in (None, "degree", "metropolis"):
        _, port, _, state = _pair(feds, "mlp", "closed_form", policy)
        impl = port._round_impl

        def spy(*args, _impl=impl, **kw):
            passed.append(args[4] if len(args) > 4 else kw.get("iw"))
            return _impl(*args, **kw)
        port._round_impl = spy
        rng = np.random.default_rng(0)
        for r in range(2):
            state, _ = port.round(state, r, rng)
        sched = port.schedule(3, rng, start_round=2)
        assert sched.iw is None and "iw" not in port._window_columns(sched)
        state, _ = port.run_chunk(state, sched, "scan_fused")
        states[policy] = _leaves(state)
    assert len(passed) == 15 and all(w is None for w in passed)
    assert all(torch.equal(a, b) for a, b in zip(states[None],
                                                 states["degree"]))


def test_lyapunov_follows_the_reference(feds):
    """L_β and the constraint residual after four biased rounds, the
    reference's key shared by every client: 1e-5 relative."""
    ref, port, r_state, state = _pair(feds, "mlr", "closed_form",
                                      "staleness")
    rng_r, rng_t = np.random.default_rng(4), np.random.default_rng(4)
    for r in range(4):
        r_state, _ = ref.round(r_state, r, rng_r)
        state, _ = port.round(state, r, rng_t)
    want = ref.lyapunov(r_state, jax.random.PRNGKey(7))
    got = port.lyapunov(state, prng.prng_key(7))
    assert set(got) == set(want) == {"L_beta", "violation"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0)
    assert got["violation"] > 0


# ---------------------------------------------------------------- card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (captured windows, the kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", [None, "roundrobin", "simultaneous"])
@pytest.mark.parametrize("policy", ["staleness", "label_skew"])
def test_captured_biased_windows_on_card(cuda_device, policy, fleet):
    """Two captured windows (the second a replay with new ``iw``
    values) against the same rounds: ``scan`` ≡ eager and ``scan_fused``
    ≡ the rounds uncaptured, bit for bit."""
    fed = _fed("port")
    out = {}
    for engine in ("eager", "scan", "scan_fused", "loop"):
        kw = dict(zone_size=ZONE, batch_size=BATCH, solver="closed_form",
                  walk_policy=policy, walk_bias=0.5, device=cuda_device)
        data = to_device_data(fed, cuda_device)
        tr = (FleetRWSADMMTrainer(MLP(SHAPE, hidden=16), data,
                                  RWSADMMHparams(**HP), n_walkers=3,
                                  sync_every=2, fleet_mode=fleet, **kw)
              if fleet else RWSADMMTrainer(MLP(SHAPE, hidden=16), data,
                                           RWSADMMHparams(**HP), **kw))
        rng, state = np.random.default_rng(0), tr.init_state(0)
        iws = []
        for start in (0, 4):
            if engine == "eager":
                for r in range(start, start + 4):
                    state, _ = tr.round(state, r, rng)
                continue
            sched = tr.schedule(4, rng, start_round=start)
            iws.append(sched.iw)
            if engine == "loop":
                ins = {k: torch.as_tensor(v, device=cuda_device)
                       for k, v in tr._window_columns(sched).items()}
                state, _, _ = tr._window(state, ins, True)
            else:
                state, _ = tr.run_chunk(state, sched, engine)
        torch.cuda.synchronize()
        out[engine] = [t.clone() for t in _leaves(state)]
        if engine == "scan":
            assert not np.array_equal(iws[0], iws[1])
            assert sum(w.replays for w in tr.windows.values()) == 2
    assert all(torch.equal(a, b) for a, b in zip(out["eager"], out["scan"]))
    assert all(torch.equal(a, b)
               for a, b in zip(out["loop"], out["scan_fused"]))
