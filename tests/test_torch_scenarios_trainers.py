"""The port's trainers in the reference's scenarios, against the JAX
package's, on the CPU.

* ``RWSADMMTrainer`` (MLR, ``N_CLIENTS`` clients, ``closed_form``) under
  ``field_trial``, ``lossy_links``, ``duty_cycle`` and the default
  ``scenario=None``, on ``eager``, ``scan`` and ``scan_fused`` (the zone
  kernel's plain version): both packages from the same initial weights
  through ``run_simulation``; the host columns (visited client, zone,
  ``n_i``, ``latency_s``, ``energy_j``, staleness, ``comm_bytes``), the
  result's totals and its ``curve()`` rounds equal by ``==``, and x, z
  and y after ``TIER_B_ROUNDS`` rounds within the round tier's 1e-6 (each
  package drawing its own batches from the reference's keys).
  ``scenario=None`` prices every round as the reference does, so its
  ``latency_s`` and ``energy_j`` are held too.

The fleet and the baselines in scenarios are in
``test_torch_scenarios_fleet.py``, which shares this file's fixtures.
"""
import jax
import numpy as np
import pytest

from repro.core.rwsadmm import RWSADMMHparams as RHP
from repro.data import make_image_dataset as r_images
from repro.data import pathological_split as r_split
from repro.data.loader import build_federated as r_build
from repro.fl.base import to_device_data as r_device
from repro.fl.fleet_trainer import FleetRWSADMMTrainer as RFleet
from repro.fl.rwsadmm_trainer import RWSADMMTrainer as RTrainer
from repro.fl.simulation import run_simulation as r_run
from repro.models import small as RSm
from repro_torch import convert
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.data import build_federated, make_image_dataset, \
    pathological_split
from repro_torch.fl import FleetRWSADMMTrainer, RWSADMMTrainer, \
    run_simulation, to_device_data
from repro_torch.fl.base import validate_round_metrics
from repro_torch.models.small import MLR
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPE, N_CLIENTS, ZONE, BATCH = (8, 8, 1), 20, 4, 6
HP = dict(beta=10.0, kappa=0.01, epsilon=1e-3)
# Windows of EVAL rounds, so the tier-b window (TIER_B_ROUNDS) reuses the
# run's compiled scan and captured shapes.
ROUNDS, EVAL, TIER_B_ROUNDS = 12, 3, 3
TOL = dict(atol=1e-6, rtol=1e-6)
HOST = ("client", "clients", "walker", "zone", "n_i", "latency_s",
        "energy_j", "staleness_p50", "staleness_max", "comm_bytes")


def _fed(pkg):
    images, split, build = ((r_images, r_split, r_build) if pkg == "ref"
                            else (make_image_dataset, pathological_split,
                                  build_federated))
    imgs, labels = images(400, shape=SHAPE, seed=0)
    return build(imgs, labels, split(labels, N_CLIENTS, seed=0), seed=0)


@pytest.fixture(scope="module")
def feds():
    return r_device(_fed("ref")), to_device_data(_fed("port"), "cpu")


def _pair(feds, scenario, fleet_mode=None):
    kw = dict(zone_size=ZONE, batch_size=BATCH, solver="closed_form",
              scenario=scenario, seed=0)
    if fleet_mode is not None:
        kw.update(n_walkers=3, sync_every=4, fleet_mode=fleet_mode)
        ref = RFleet(RSm.make_mlr(SHAPE), feds[0], RHP(**HP), **kw)
        port = FleetRWSADMMTrainer(MLR(SHAPE), feds[1], RWSADMMHparams(**HP),
                                   device="cpu", **kw)
    else:
        ref = RTrainer(RSm.make_mlr(SHAPE), feds[0], RHP(**HP), **kw)
        port = RWSADMMTrainer(MLR(SHAPE), feds[1], RWSADMMHparams(**HP),
                              device="cpu", **kw)
    r_state = ref.init_state(jax.random.PRNGKey(0))
    y = r_state.base.server.y if fleet_mode else r_state.server.y
    params = convert._flat_rows(jax.tree_util.tree_map(np.asarray, y), 0)
    port.init_state = lambda seed, params=params, init=port.init_state: \
        init(seed, params)
    return ref, port


def _assert_host_columns(r_res, res):
    validate_round_metrics(res.round_metrics)
    assert set(res.round_metrics[0]) == set(r_res.round_metrics[0])
    for key in HOST:
        assert [m.get(key) for m in res.round_metrics] == \
            [m.get(key) for m in r_res.round_metrics], key
    assert res.total_comm_bytes == r_res.total_comm_bytes
    assert res.total_latency_s == r_res.total_latency_s
    assert res.total_energy_j == r_res.total_energy_j


def _rows(tree, lead):
    return convert._flat_rows(jax.tree_util.tree_map(np.asarray, tree),
                              lead).numpy()


@pytest.mark.parametrize("engine", ["eager", "scan", "scan_fused"])
@pytest.mark.parametrize("scenario", [None, "field_trial", "lossy_links",
                                      "duty_cycle"])
def test_single_walker_matches_reference(feds, scenario, engine):
    ref, port = _pair(feds, scenario)
    r_res = r_run(ref, rounds=ROUNDS, eval_every=EVAL, seed=0, engine=engine)
    res = run_simulation(port, rounds=ROUNDS, eval_every=EVAL, seed=0,
                         engine=engine)
    _assert_host_columns(r_res, res)
    assert res.total_latency_s > 0 and res.total_energy_j > 0
    assert np.array_equal(res.curve("acc")[0], r_res.curve("acc")[0])
    np.testing.assert_allclose([m["train_loss"] for m in res.round_metrics],
                               [m["train_loss"] for m in r_res.round_metrics],
                               atol=1e-5, rtol=1e-5)

    # Tier b: x, z, y after a few rounds on each package's own draws, on
    # the same trainers with their environments rebuilt.
    ref.attach_scenario(scenario, seed=0)
    port.attach_scenario(scenario, seed=0)
    r_state = ref.init_state(jax.random.PRNGKey(0))
    state = port.init_state(0)
    r_rng, rng = np.random.default_rng(1), np.random.default_rng(1)
    if engine == "eager":
        for r in range(TIER_B_ROUNDS):
            r_state, _ = ref.round(r_state, r, r_rng)
            state, _ = port.round(state, r, rng)
    else:
        r_state, _ = ref.run_chunk(r_state, ref.schedule(TIER_B_ROUNDS,
                                                         r_rng), engine)
        state, _ = port.run_chunk(state, port.schedule(TIER_B_ROUNDS, rng),
                                  engine)
    for leaf, got, want, lead in (
            ("x", state.clients.x, r_state.clients.x, 1),
            ("z", state.clients.z, r_state.clients.z, 1),
            ("y", state.server.y, r_state.server.y, 0)):
        np.testing.assert_allclose(got.numpy(), _rows(want, lead),
                                   err_msg=leaf, **TOL)
