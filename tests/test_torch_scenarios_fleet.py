"""The port's fleet and baselines in the reference's scenarios, against
the JAX package's, on the CPU (the fixtures and helpers of
``test_torch_scenarios_trainers.py``).

* The fleet in both modes under ``lossy_links`` (eager and
  ``scan_fused``): host columns, the wall step's prices (the slowest
  walker's latency, the walkers' summed energy), totals.
* Walkman and FedAvg under ``duty_cycle``: cohorts drawn only from awake
  clients, visited clients, ``comm_bytes``, ``latency_s`` and
  ``energy_j`` equal; FedAvg's prices are the base station's.
* A cohort baseline's ``scenario=`` is what ``run_simulation(scenario=)``
  attaches.
"""
import numpy as np
import pytest

from repro.baselines import FedAvgTrainer as RFedAvg
from repro.baselines import WalkmanTrainer as RWalkman
from repro.fl.simulation import run_simulation as r_run
from repro.models import small as RSm
from repro_torch.baselines import FedAvgTrainer, WalkmanTrainer
from repro_torch.fl import run_simulation
from repro_torch.models.small import MLR
from repro_torch.scenarios import Scenario
from test_torch_scenarios_trainers import BATCH, EVAL, N_CLIENTS, ROUNDS, \
    SHAPE, _assert_host_columns, _pair, feds
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

__all__ = ["feds"]   # the fixture, found by name in this module


@pytest.mark.parametrize("engine", ["eager", "scan_fused"])
@pytest.mark.parametrize("mode", ["roundrobin", "simultaneous"])
def test_fleet_matches_reference_under_lossy_links(feds, mode, engine):
    ref, port = _pair(feds, "lossy_links", fleet_mode=mode)
    r_res = r_run(ref, rounds=ROUNDS, eval_every=EVAL, seed=0, engine=engine)
    res = run_simulation(port, rounds=ROUNDS, eval_every=EVAL, seed=0,
                         engine=engine)
    _assert_host_columns(r_res, res)
    if mode == "simultaneous" and engine == "scan_fused":
        # Wall-step prices: the slowest walker's latency, summed energy.
        sched = port.schedule(4, np.random.default_rng(0), start_round=ROUNDS)
        assert np.array_equal(sched.latency_s,
                              sched.latency_s_walkers.max(axis=1))
        assert np.array_equal(sched.energy_j,
                              sched.energy_j_walkers.sum(axis=1))


def _recorded_cohorts(trainer):
    cohorts, select = [], trainer.select_clients

    def record(*args):
        cohorts.append(np.asarray(select(*args)).tolist())
        return cohorts[-1]
    trainer.select_clients = record
    return cohorts


@pytest.mark.parametrize("name", ["fedavg", "walkman"])
def test_baselines_match_reference_under_duty_cycle(feds, name):
    if name == "fedavg":
        ref = RFedAvg(RSm.make_mlr(SHAPE), feds[0], clients_per_round=5,
                      local_steps=2, batch_size=BATCH)
        port = FedAvgTrainer(MLR(SHAPE), feds[1], clients_per_round=5,
                             local_steps=2, batch_size=BATCH, device="cpu")
    else:
        ref = RWalkman(RSm.make_mlr(SHAPE), feds[0], batch_size=BATCH)
        port = WalkmanTrainer(MLR(SHAPE), feds[1], batch_size=BATCH,
                              device="cpu")
    cohorts = (_recorded_cohorts(ref), _recorded_cohorts(port))
    r_res = r_run(ref, rounds=ROUNDS, eval_every=EVAL, seed=3,
                  scenario="duty_cycle")
    res = run_simulation(port, rounds=ROUNDS, eval_every=EVAL, seed=3,
                         scenario="duty_cycle")
    _assert_host_columns(r_res, res)
    assert cohorts[0] == cohorts[1]
    assert np.array_equal(res.curve("acc")[0], r_res.curve("acc")[0])
    if name == "walkman":          # near-field hand-off: priced at zero
        assert res.total_latency_s == res.total_energy_j == 0.0
        return
    # Every cohort comes from the clients awake that round (the replay
    # of the scenario's positions-only lane), priced at the base station.
    scn = Scenario(N_CLIENTS, "duty_cycle", seed=3, positions_only=True)
    for r, (cohort, m) in enumerate(zip(cohorts[1], res.round_metrics)):
        if r:
            scn.step()
        assert set(cohort) <= set(np.flatnonzero(scn.availability()))
        assert (m["latency_s"], m["energy_j"]) == scn.price_star_round(
            np.asarray(cohort), port.params_bytes())


def test_scenario_kwarg_equals_run_simulation_attach(feds):
    """A cohort baseline's ``scenario=`` (seeded with ``seed``) is the
    environment ``run_simulation(scenario=, seed=)`` attaches."""
    a = FedAvgTrainer(MLR(SHAPE), feds[1], clients_per_round=4,
                      local_steps=1, batch_size=BATCH, device="cpu",
                      scenario="field_trial", seed=2)
    b = FedAvgTrainer(MLR(SHAPE), feds[1], clients_per_round=4,
                      local_steps=1, batch_size=BATCH, device="cpu")
    ra = run_simulation(a, rounds=4, eval_every=4, seed=2)
    rb = run_simulation(b, rounds=4, eval_every=4, seed=2,
                        scenario="field_trial")
    assert [m["latency_s"] for m in ra.round_metrics] == \
        [m["latency_s"] for m in rb.round_metrics]
    assert ra.total_energy_j == rb.total_energy_j > 0
