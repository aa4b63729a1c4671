"""The paper-script twins' host-only outputs against the reference's
trainers, on the CPU: the walk-policy sweep's hitting times and
staleness, Table 2's ``comm_mb``, and the mixing report (τ, σ, λ₂, Eq. 3,
App. D.2). These depend only on the host control plane (graphs, walks,
zones, the trainers' byte counts), which both packages run in numpy from
the same seeds, so they compare by ``==``. The reference side plans its
rounds with its trainers' own ``schedule()`` and
``chunk_round_metrics()``, the columns its ``run_simulation`` emits; the
reference's ``policy_sweep`` is not called (it writes
``BENCH_scaling.json``).
"""
import numpy as np
import pytest

from benchmarks import common as RC
from benchmarks import mixing_torch, table2_scaling_torch
from repro.core import graph as RG
from repro.core import markov as RM
from repro.core.rwsadmm import RWSADMMHparams as RHP
from repro.fl.rwsadmm_trainer import RWSADMMTrainer as RTrainer
from repro.models.small import get_model as r_model
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _ref_plan(trainer, rounds, seed):
    """The reference trainer's round metrics over ``rounds`` rounds from
    the seed's host RNG, losses zeroed (the host columns only)."""
    sched = trainer.schedule(rounds, np.random.default_rng(seed))
    zeros = np.zeros(rounds, np.float32)
    return trainer.chunk_round_metrics(
        sched, {"train_loss": zeros, "kappa": zeros}, 0)


def test_mixing_report_equals_reference():
    rng = np.random.default_rng(0)
    graphs = [RG.random_geometric_graph(20, 5, rng),
              RG.random_geometric_graph(100, 5, rng),
              RG.random_geometric_graph(100, 20, rng),
              RG.line_graph(20), RG.complete_graph(20)]
    rows = mixing_torch.mixing_report()
    for row, g in zip(rows, graphs):
        rep = RM.verify_assumption_3_1(RM.degree_transition_matrix(g), 0.5)
        assert {k: row[k] for k in rep} == rep
        assert row["appD2"] == bool(rep["lambda2"]
                                    < 1 - 1 / g.n_edges ** (2 / 3))


def test_policy_sweep_host_outputs_equal_reference(tmp_path):
    """The sweep at its smoke size (n = 12, 40 rounds, seeds 0 and 1):
    each policy's mean hitting time, worst and final median staleness
    equal the reference trainers' from the same seeds."""
    rows = mixing_torch.policy_sweep(smoke=True, device="cpu",
                                     out=str(tmp_path / "rows.json"))
    rounds, seeds = rows[0]["rounds"], (0, 1)
    data, shape = RC.mnist_like_fed(12, n_samples=1200, seed=0)
    for row, policy in zip(rows, RM.WALK_POLICIES):
        hits, smaxs, p50s = [], [], []
        for seed in seeds:
            tr = RTrainer(r_model("mlr", shape), data,
                          RHP(beta=10.0, kappa=0.001, epsilon=1e-5),
                          zone_size=4, batch_size=20, solver="closed_form",
                          walk_policy=policy, walk_bias=0.5, seed=seed)
            metrics = _ref_plan(tr, rounds, seed)
            hit = tr.walker.hitting_time()
            hits.append(hit if hit is not None else rounds + 1)
            smaxs.append(max(m["staleness_max"] for m in metrics))
            p50s.append(metrics[-1]["staleness_p50"])
        assert row["name"] == f"walk_policy/{policy}"
        assert (row["hitting_time"], row["staleness_max"],
                row["staleness_p50"]) == (float(np.mean(hits)),
                                          float(np.mean(smaxs)),
                                          float(np.mean(p50s)))


@pytest.mark.parametrize("n", [10, 16])
def test_table2_comm_equals_reference(tmp_path, n):
    """Table 2's row at n clients for 2n rounds: ``comm_mb`` equals the
    reference trainer's byte count over the same rounds."""
    row, = table2_scaling_torch.run(str(tmp_path), "cpu", clients=(n,),
                                    rounds_per_client=2)
    data, shape = RC.mnist_like_fed(n_clients=n, n_samples=200 * n)
    ref = RC.make_trainer("rwsadmm", r_model("mlp", shape), data, zone=8)
    metrics = _ref_plan(ref, 2 * n, 0)
    total = sum(m["comm_bytes"] for m in metrics)
    assert row["comm_mb"] == round(total / 1e6, 1)
    assert (row["n_clients"], row["rounds"]) == (n, 2 * n)
