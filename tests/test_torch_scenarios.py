"""The port's scenario subsystem (``repro_torch.scenarios``) and its
control plane against the JAX package's, on the CPU.

Everything here is host-side numpy in both packages, so every column is
held by ``==``: for each preset over ``ROUNDS`` rounds the positions,
graphs (dense adjacency, or the sparse lane's neighbor lists and
distances), availability masks, and the schedule a walker plans over
them (visited client, zones, masks, ``n_i``, keys) with its
``latency_s`` and ``energy_j`` prices. The sparse backend is held to the
reference's sparse backend (its link dropout draws per edge, a
documented break of the RNG stream between backends), never to the
dense one. Then the rollout's chunk-size invariance, ``static_regen`` ≡
``DynamicGraph``, the positions-only lane, star pricing, trace replay,
the chain's spectral diagnostics, and the scenario twins
(``scenario_sweep_torch``, ``comm_cost_torch``, ``mobile_server_sim_torch``,
``scan_scaling_torch --control-plane``) end to end on the CPU.
"""
import dataclasses
import importlib.util
import math
import pathlib

import numpy as np
import pytest

import repro.scenarios as RS
from repro.core import graph as RG
from repro.core import markov as RM
from repro_torch import scenarios as TS
from repro_torch.core import graph as TG
from repro_torch.core import markov as TM
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROUNDS, ZONE, PAYLOAD = 30, 6, 1_068_266 * 4
PRESETS = ["static_regen", "random_waypoint", "gauss_markov", "lossy_links",
           "duty_cycle", "field_trial"]
#: (preset, backend, n): every preset dense at n = 60; the two with link
#: dropout also sparse at n = 200 (the cap above the realized degree)
CASES = ([(p, "dense", 60) for p in PRESETS]
         + [(p, "sparse", 200) for p in ("lossy_links", "field_trial")])


def _configs(preset, backend, **kw):
    return tuple(dataclasses.replace(pkg.get_scenario_config(preset),
                                     graph_backend=backend, **kw)
                 for pkg in (RS, TS))


def _assert_graphs_equal(ref, port):
    assert type(ref).__name__ == type(port).__name__
    assert np.array_equal(ref.positions, port.positions)
    if isinstance(port, TG.NeighborGraph):
        for f in ("nbrs", "nbr_mask", "nbr_d2"):
            assert np.array_equal(getattr(ref, f), getattr(port, f)), f
    else:
        assert np.array_equal(ref.adjacency, port.adjacency)


def _assert_trace_equal(ref, port):
    assert (ref is None) == (port is None)
    if port is not None:
        assert np.array_equal(ref, port)


@pytest.mark.parametrize("preset,backend,n", CASES)
def test_rollout_equals_reference(preset, backend, n):
    """Positions, graphs and availability over ``ROUNDS`` rounds."""
    r_cfg, t_cfg = _configs(preset, backend)
    ref, port = RS.Scenario(n, r_cfg, seed=5), TS.Scenario(n, t_cfg, seed=5)
    _assert_graphs_equal(ref.current(), port.current())
    _assert_trace_equal(ref.availability(), port.availability())
    for a, b in zip(ref.schedule(ROUNDS, include_current=True),
                    port.schedule(ROUNDS, include_current=True)):
        _assert_graphs_equal(a, b)
    trace = port.pop_avail_trace()
    _assert_trace_equal(ref.pop_avail_trace(), trace)
    assert ref.n_regens == port.n_regens
    # Churn takes clients offline in some round (else it is not tested).
    assert (trace is None) == (t_cfg.churn.enabled is False)
    assert trace is None or not trace.all()


@pytest.mark.parametrize("preset,backend,n", CASES)
def test_priced_schedule_equals_reference(preset, backend, n):
    """A walker's priced zone schedule over the scenario, in two windows
    (the second continues the first): every column by ``==``."""
    r_cfg, t_cfg = _configs(preset, backend)
    runs = []
    for pkg, markov, cfg in ((RS, RM, r_cfg), (TS, TM, t_cfg)):
        scn = pkg.Scenario(n, cfg, seed=2)
        walker = markov.RandomWalkServer(seed=3)
        walker.reset(scn.current())
        rng = np.random.default_rng(4)

        def price(graphs, clients, idx, mask, scn=scn):
            return scn.price_schedule(graphs, clients, idx, mask, PAYLOAD)
        runs.append([markov.zone_schedule(scn, walker, r, ZONE, rng,
                                          start_round=s, price=price)
                     for s, r in ((0, ROUNDS // 2), (ROUNDS // 2,
                                                     ROUNDS // 2))])
        runs[-1].append(walker.hitting_time())
    for ref, port in zip(runs[0][:2], runs[1][:2]):
        for col in ("idx", "mask", "n_i", "clients", "active", "latency_s",
                    "energy_j"):
            a, b = getattr(ref, col), getattr(port, col)
            assert a.dtype == b.dtype and np.array_equal(a, b), col
        assert np.array_equal(np.asarray(ref.keys).astype(np.int64),
                              port.keys)
    assert runs[0][2] == runs[1][2]


@pytest.mark.parametrize("preset", ["field_trial", "lossy_links",
                                    "duty_cycle"])
def test_schedule_is_chunk_size_invariant(preset):
    """Any ``rollout_chunk``, and the per-round stepping oracle, give the
    same graphs and masks: RNG use does not depend on the chunk."""
    outs = []
    for chunk, batched in ((1, True), (7, True), (128, True), (128, False)):
        cfg = dataclasses.replace(TS.get_scenario_config(preset),
                                  rollout_chunk=chunk)
        scn = TS.Scenario(40, cfg, seed=11)
        graphs = scn.schedule(ROUNDS, include_current=True, batched=batched)
        outs.append((graphs, scn.pop_avail_trace()))
    for graphs, trace in outs[1:]:
        for a, b in zip(outs[0][0], graphs):
            _assert_graphs_equal(a, b)
        _assert_trace_equal(outs[0][1], trace)


def test_default_scenario_is_dynamic_graph():
    """``build_scenario(None, …)`` reproduces ``DynamicGraph`` bit for
    bit, regeneration epochs included, in both of its lanes."""
    dyn = TG.DynamicGraph(50, 4, 3, seed=9)
    batched = TS.build_scenario(None, 50, seed=9, min_degree=4,
                                regen_every=3)
    stepped = TS.build_scenario(None, 50, seed=9, min_degree=4,
                                regen_every=3)
    want = dyn.schedule(ROUNDS, include_current=True)
    got = batched.schedule(ROUNDS, include_current=True)
    got_stepped = stepped.schedule(ROUNDS, include_current=True,
                                   batched=False)
    for w, a, b in zip(want, got, got_stepped):
        _assert_graphs_equal(w, a)
        _assert_graphs_equal(w, b)
    assert batched.n_regens == dyn.n_regens == (ROUNDS - 1) // 3
    assert batched.pop_avail_trace() is None


@pytest.mark.parametrize("preset", ["duty_cycle", "field_trial"])
def test_positions_only_lane_and_star_pricing(preset):
    """The baselines' lane: positions and churn masks as the full lane's
    and the reference's, and base-station prices equal the reference's."""
    ref = RS.Scenario(30, preset, seed=1, positions_only=True)
    port = TS.Scenario(30, preset, seed=1, positions_only=True)
    full = TS.Scenario(30, preset, seed=1)
    members = np.array([3, 7, 7, 21])
    for r in range(ROUNDS):
        if r:
            ref.step(), port.step(), full.step()
        assert np.array_equal(port.positions, ref.positions)
        assert np.array_equal(port.positions, full.positions)
        assert np.array_equal(port.availability(), ref.availability())
        assert port.price_star_round(members, PAYLOAD) == \
            ref.price_star_round(members, PAYLOAD)
    with pytest.raises(RuntimeError, match="positions-only"):
        port.current()


def test_trace_mobility_replays_registered_positions():
    frames = np.random.default_rng(0).uniform(size=(4, 25, 2))
    for pkg in (RS, TS):
        pkg.register_trace("port_twin_trace", frames)
    cfg = {pkg: dataclasses.replace(
        pkg.get_scenario_config("lossy_links"),
        mobility=pkg.MobilityConfig(model="trace",
                                    trace_path="port_twin_trace"))
        for pkg in (RS, TS)}
    ref, port = RS.Scenario(25, cfg[RS], seed=0), TS.Scenario(25, cfg[TS],
                                                                 seed=0)
    for r, (a, b) in enumerate(zip(ref.schedule(9, include_current=True),
                                   port.schedule(9, include_current=True))):
        _assert_graphs_equal(a, b)
        assert np.array_equal(b.positions, frames[r % 4])
    with pytest.raises(ValueError, match="unit square"):
        TS.register_trace("bad", frames + 1.0)


def test_sparse_graph_equals_dense_where_rng_free():
    """The sparse lane's graphs equal the dense lane's (RNG-free), and
    ``neighbor_graph_from_dense`` round-trips."""
    pos = np.random.default_rng(3).uniform(size=(150, 2))
    dense = TS.range_graph(pos, 0.12, 5)
    sparse = TS.sparse_range_graph(pos, 0.12, 5, k_max=64)
    assert np.array_equal(sparse.to_dense().adjacency, dense.adjacency)
    via = TG.neighbor_graph_from_dense(dense)
    for f in ("nbrs", "nbr_mask", "nbr_d2"):
        assert np.array_equal(getattr(via, f), getattr(sparse, f)), f
    ref = RS.sparse_knn_graph(pos, 5, 64)
    port = TS.sparse_knn_graph(pos, 5, 64)
    _assert_graphs_equal(ref, port)


def test_spectral_diagnostics_equal_reference():
    g = RG.random_geometric_graph(30, 5, np.random.default_rng(0))
    tg = TG.random_geometric_graph(30, 5, np.random.default_rng(0))
    p, tp = RM.degree_transition_matrix(g), TM.degree_transition_matrix(tg)
    assert np.array_equal(p, tp)
    assert TM.lambda2(tp) == RM.lambda2(p)
    assert TM.mixing_time(tp) == RM.mixing_time(p)
    assert TM.verify_assumption_3_1(tp) == RM.verify_assumption_3_1(p)
    assert np.array_equal(TM.p_max_envelope([tp, tp.T]),
                          RM.p_max_envelope([p, p.T]))


# ---------------------------------------------------------------- twins --
def _load(name: str):
    path = ROOT / name
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_mobile_server_sim_twin_prints_the_references_lines(capsys):
    """The example's control plane is host numpy in both packages, so its
    printout equals the reference example's, line for line."""
    _load("examples/mobile_server_sim_torch.py").main(
        ["field_trial", "static_regen"], rounds=40)
    got = capsys.readouterr().out
    ref = _load("examples/mobile_server_sim.py")
    ref.ROUNDS = 40
    for name in ("field_trial", "static_regen"):
        ref.simulate(name)
    assert got.splitlines()[:-2] == capsys.readouterr().out.splitlines()
    assert "latency" in got and "Assumption 3.1" in got


def test_scenario_twins_run_on_cpu(tmp_path):
    import benchmarks.comm_cost_torch as cc
    import benchmarks.scan_scaling_torch as ss
    import benchmarks.scenario_sweep_torch as sw

    rows = sw.run(n_clients=8, rounds=2, speedup_rounds=3, smoke=True,
                  out_dir=str(tmp_path), device="cpu", reps=1)
    assert [r["scenario"] for r in rows] == [c.name for c in sw.grid()]
    assert all(r["latency_s"] > 0 and r["energy_j"] > 0 for r in rows)
    rows = cc.run(rounds=2, out_dir=str(tmp_path), device="cpu",
                  algos=["fedavg", "rwsadmm"])
    assert rows[0]["latency_s_per_round"] > rows[1]["latency_s_per_round"]
    assert all(math.isfinite(r["final_acc"]) for r in rows)
    out = tmp_path / "scaling.json"
    res = ss.control_plane(clients=(300,), rounds=4, out=str(out))
    assert res[300] > 0 and "control_plane/n300/sparse" in out.read_text()
