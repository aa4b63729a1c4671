"""The port's telemetry (``repro_torch.telemetry``) against the
reference's: the same event schema, the report renderer on one events
file, bench-row merging, manifest determinism, a recorded run bit for bit
the unrecorded one (single walker and K = 3 fleet, eager and scan, dense
and sparse graphs, the lazy plane), round and visit events equal to the
reference's for the same seed and weights, and the store's counters
against an LRU oracle."""
import collections
import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from repro_torch import convert
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.data import build_federated, factory_from_federated, \
    make_image_dataset, pathological_split
from repro_torch.fl.base import to_device_data, validate_round_metrics
from repro_torch.fl.client_store import STORE_COUNTERS
from repro_torch.fl.fleet_trainer import FleetRWSADMMTrainer
from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer
from repro_torch.fl.simulation import run_simulation
from repro_torch.models.small import get_model
from repro_torch.scenarios import get_scenario_config
from repro_torch.telemetry import SCHEMA_VERSION, TelemetryError, \
    TelemetryRun, atomic_write_json, load_bench_rows, manifest_fingerprint, \
    merge_bench_rows, read_events, split_by_type, validate_event
from repro_torch.telemetry.report import render_report, summarize
from repro_torch.telemetry.smoke import smoke_run
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 8


def _federated():
    imgs, labels = make_image_dataset(400, seed=0)
    return build_federated(imgs, labels, pathological_split(labels, N,
                                                            seed=0))


@pytest.fixture(scope="module")
def fed():
    f = _federated()
    return to_device_data(f, "cpu"), factory_from_federated(f)


def _scenario(backend: str):
    return dataclasses.replace(get_scenario_config("lossy_links"),
                               graph_backend=backend, neighbor_k_max=8)


def _make_trainer(fed, backend="dense", fleet=0, lazy=False, capacity=8,
                  telemetry=None):
    data = fed[1] if lazy else fed[0]
    kw = dict(zone_size=4, batch_size=16, solver="closed_form",
              scenario=_scenario(backend), seed=0, device="cpu",
              telemetry=telemetry)
    if lazy:
        kw["store_capacity"] = capacity
    model = get_model("mlr", (28, 28, 1))
    if fleet:
        return FleetRWSADMMTrainer(model, data, RWSADMMHparams(beta=10.0),
                                   n_walkers=fleet, sync_every=3, **kw)
    return RWSADMMTrainer(model, data, RWSADMMHparams(beta=10.0), **kw)


def _run(trainer, *, engine, telemetry=None, rounds=8):
    return run_simulation(trainer, rounds=rounds, eval_every=4, seed=0,
                          engine=engine, telemetry=telemetry)


def _assert_same(res_off, res_on):
    assert res_off.round_metrics == res_on.round_metrics
    assert res_off.history == res_on.history
    assert res_off.total_comm_bytes == res_on.total_comm_bytes


# ------------------------------------------------------- on ≡ off --
@pytest.mark.parametrize("engine", ["eager", "scan"])
@pytest.mark.parametrize("backend", ["dense", "sparse"])
@pytest.mark.parametrize("fleet", [0, 3])
def test_telemetry_on_is_bit_identical(fed, tmp_path, engine, backend,
                                       fleet):
    """Recording a run does not change it, and every event type is
    recorded."""
    res_off = _run(_make_trainer(fed, backend, fleet), engine=engine)
    with TelemetryRun(str(tmp_path / "run"), seed=0) as tel:
        res_on = _run(_make_trainer(fed, backend, fleet), engine=engine,
                      telemetry=tel)
    _assert_same(res_off, res_on)
    b = split_by_type(read_events(tel.events_path))
    assert len(b["round"]) == 8
    assert b["visit"] and b["snapshot"] and b["phase"] and b["counter"]
    names = {p["name"] for p in b["phase"]}
    assert {"init_state", "eval"} <= names
    assert ({"schedule", "scenario_rollout", "scan_chunk"}
            if engine == "scan" else {"round_eager"}) <= names


def test_visit_trace_identical_across_engines(fed, tmp_path):
    streams = {}
    for engine in ("eager", "scan"):
        with TelemetryRun(str(tmp_path / engine), seed=0) as tel:
            _run(_make_trainer(fed), engine=engine, telemetry=tel)
        streams[engine] = [e for e in read_events(tel.events_path)
                           if e["t"] == "visit"]
    assert streams["eager"] == streams["scan"]


# -------------------------------------------------------- schema --
def test_event_schema_is_the_references():
    from repro.telemetry import EVENT_TYPES as R_TYPES
    from repro.telemetry import SCHEMA_VERSION as R_VERSION
    from repro_torch.telemetry import EVENT_TYPES

    assert SCHEMA_VERSION == R_VERSION and EVENT_TYPES == R_TYPES


def test_event_validation():
    validate_event({"t": "visit", "round": 0, "client": 3})
    with pytest.raises(TelemetryError, match="unknown event type"):
        validate_event({"t": "nope"})
    with pytest.raises(TelemetryError, match="missing required"):
        validate_event({"t": "phase", "name": "x"})


def test_event_roundtrip_and_report(tmp_path):
    run_dir = str(tmp_path / "run")
    tel = smoke_run(run_dir, rounds=5, eval_every=5, device="cpu")
    events = list(read_events(tel.events_path))
    b = split_by_type(events)
    assert len(b["round"]) == 5 and len(b["visit"]) == 5
    assert len(b["snapshot"]) == 1
    counts = tel.manifest["event_counts"]
    assert counts["round"] == 5 and counts["visit"] == 5
    assert tel.manifest["status"] == "finalized"
    assert tel.manifest["torch"]["backend"] == "cpu"
    report = render_report(run_dir)
    for section in ("== Run ==", "== Convergence ==",
                    "== Coverage & staleness ==", "== Communication ==",
                    "== Phase times ==", "== Counters =="):
        assert section in report, report
    assert "scan_chunk" in report and "scenario_rollout" in report
    s = summarize(run_dir)
    assert s["n_rounds"] == 5 and s["comm_bytes_total"] > 0
    assert s["latency_s_total"] > 0
    assert any(p["name"] == "scan_chunk" and p["includes_compile"]
               for p in s["phases"])


def test_fleet_report_has_walker_table(tmp_path):
    run_dir = str(tmp_path / "fleet")
    smoke_run(run_dir, rounds=6, eval_every=3, fleet=3, device="cpu")
    assert "== Walkers ==" in render_report(run_dir)
    s = summarize(run_dir)
    assert set(s["walkers"]) == {0, 1, 2}
    assert sum(w["visits"] for w in s["walkers"].values()) == 6


def test_report_renders_the_references_events_alike(tmp_path):
    """The port's renderer on a run the reference recorded: every line
    equals the reference renderer's but the one naming the runtime (the
    reference's manifest has no ``torch`` block)."""
    from repro.telemetry.report import render_report as r_render
    from repro.telemetry.smoke import smoke_run as r_smoke

    run_dir = str(tmp_path / "ref")
    r_smoke(run_dir, rounds=4, eval_every=2)
    got, want = render_report(run_dir).splitlines(), \
        r_render(run_dir).splitlines()
    assert len(got) == len(want)
    diff = [(a, b) for a, b in zip(got, want) if a != b]
    assert len(diff) == 1 and diff[0][0].startswith("backend:"), diff


def test_profile_opt_in_writes_a_trace(tmp_path):
    """``profile=True`` wraps the run in ``torch.profiler`` and writes a
    Chrome trace under the run's ``profile/``; off, nothing."""
    on = smoke_run(str(tmp_path / "on"), rounds=2, eval_every=2,
                   device="cpu", profile=True)
    assert on.manifest["profile_dir"] == "profile"
    with open(os.path.join(on.run_dir, "profile", "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    off = smoke_run(str(tmp_path / "off"), rounds=2, eval_every=2,
                    device="cpu")
    assert not os.path.exists(os.path.join(off.run_dir, "profile"))


# ------------------------------------------------------ manifest --
def test_manifest_determinism_under_fixed_seed(tmp_path):
    t1 = smoke_run(str(tmp_path / "a"), rounds=2, eval_every=2, device="cpu")
    t2 = smoke_run(str(tmp_path / "b"), rounds=2, eval_every=2, device="cpu")
    assert t1.manifest["fingerprint"] == t2.manifest["fingerprint"]
    assert t1.manifest["fingerprint"] == manifest_fingerprint(t1.manifest)
    t3 = smoke_run(str(tmp_path / "c"), rounds=2, eval_every=2, seed=1,
                   device="cpu")
    assert t3.manifest["fingerprint"] != t1.manifest["fingerprint"]

    def det(tel):
        return [e for e in read_events(tel.events_path)
                if e["t"] != "phase" and e.get("name") != "wall_time_s"]
    assert det(t1) == det(t2)


def test_manifest_atomic_and_updatable(tmp_path):
    run_dir = str(tmp_path / "m")
    tel = TelemetryRun(run_dir, seed=7, config={"a": 1})
    with open(tel.manifest_path) as f:
        m = json.load(f)
    assert m["seed"] == 7 and m["config"] == {"a": 1}
    assert m["status"] == "open" and "jax" not in m
    assert m["torch"]["version"] and "power_limit" in m["torch"]
    tel.update_manifest(config={"b": 2})
    tel.close()
    with open(tel.manifest_path) as f:
        m = json.load(f)
    assert m["config"] == {"a": 1, "b": 2}
    assert m["status"] == "finalized"
    assert not [p for p in os.listdir(run_dir) if p.endswith(".tmp")]
    with pytest.raises(TelemetryError, match="closed"):
        tel.emit("counter", name="x", value=1)


def test_bench_rows_merge_by_identity(tmp_path):
    path = str(tmp_path / "bench.json")
    r1 = {"name": "x", "n": 10, "K": 1, "engine": "scan",
          "us_per_round": 1.0}
    r2 = {"name": "x", "n": 20, "K": 1, "engine": "scan",
          "us_per_round": 2.0}
    atomic_write_json(path, merge_bench_rows([], [r1, r2]))
    rows = merge_bench_rows(load_bench_rows(path),
                            [{**r1, "us_per_round": 9.0}])
    atomic_write_json(path, rows)
    by_n = {r["n"]: r for r in load_bench_rows(path)}
    assert by_n[10]["us_per_round"] == 9.0 and by_n[20]["us_per_round"] == 2.0
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    from repro.telemetry import merge_bench_rows as r_merge

    mixed = [r2, {"name": "a", "n": None, "K": 3, "engine": "e"}, r1]
    assert merge_bench_rows([], mixed) == r_merge([], mixed)


def test_round_metrics_validator(fed):
    res = _run(_make_trainer(fed), engine="eager", rounds=4)
    keys = validate_round_metrics(res.round_metrics)
    assert {"round", "comm_bytes", "client", "train_loss"} <= keys
    with pytest.raises(ValueError, match="missing required"):
        validate_round_metrics([{"round": 0}])


def test_baseline_telemetry_hook(fed, tmp_path):
    from repro_torch.baselines import FedAvgTrainer

    with TelemetryRun(str(tmp_path / "fa"), seed=0) as tel:
        tr = FedAvgTrainer(get_model("mlr", (28, 28, 1)), fed[0],
                           clients_per_round=4, local_steps=2,
                           device="cpu", telemetry=tel)
        res = run_simulation(tr, rounds=3, eval_every=3, seed=0,
                             telemetry=tel, verbose=True)
    assert len(res.round_metrics) == 3
    b = split_by_type(read_events(tel.events_path))
    assert len(b["round"]) == 3 and b["snapshot"]
    assert tel.manifest["config"]["algo"] == "fedavg"


def test_snapshot_without_acc_does_not_crash():
    from repro_torch.fl import simulation as sim
    from repro_torch.telemetry import null_phase

    class NoAccTrainer:
        name = "noacc"

        def evaluate(self, state):
            return {"loss_global": 1.0}

        def _phase(self, name, **meta):
            return null_phase()

    hist = []
    sim._snapshot(NoAccTrainer(), None, 5, 123, hist, True, "noacc")
    assert hist[0]["round"] == 5 and "acc" not in hist[0]


# ------------------------------------------------- against repro --
def test_round_and_visit_events_equal_the_references(fed, tmp_path):
    """One scan run of each package from the same weights and seed: the
    visit events and the round events' host columns by ``==``, the
    losses within 1e-5, the same phase names in the same order, and
    the same totals."""
    from repro.core.rwsadmm import RWSADMMHparams as RHP
    from repro.fl.base import to_device_data as r_device
    from repro.fl.rwsadmm_trainer import RWSADMMTrainer as RTrainer
    from repro.fl.simulation import run_simulation as r_run
    from repro.models import small as RS
    from repro.telemetry import TelemetryRun as RRun
    from repro.telemetry import read_events as r_read
    from repro.data import make_image_dataset as r_images
    from repro.data import pathological_split as r_split
    from repro.data.loader import build_federated as r_build

    imgs, labels = r_images(400, seed=0)
    r_data = r_device(r_build(imgs, labels, r_split(labels, N, seed=0)))
    kw = dict(zone_size=4, batch_size=16, solver="closed_form",
              scenario=_scenario("dense"), seed=0)
    ref = RTrainer(RS.make_mlr((28, 28, 1)), r_data, RHP(beta=10.0), **kw)
    with RRun(str(tmp_path / "ref"), seed=0) as r_tel:
        r_run(ref, rounds=8, eval_every=4, seed=0, engine="scan",
              telemetry=r_tel)
    y = ref.init_state(jax.random.PRNGKey(0)).server.y
    params = convert._flat_rows(jax.tree_util.tree_map(np.asarray, y), 0)
    port = _make_trainer(fed)
    init = port.init_state
    port.init_state = lambda seed: init(params=params)
    with TelemetryRun(str(tmp_path / "port"), seed=0) as tel:
        _run(port, engine="scan", telemetry=tel)
    got = split_by_type(read_events(tel.events_path))
    want = split_by_type(r_read(r_tel.events_path))
    assert got["visit"] == want["visit"]
    assert len(got["round"]) == len(want["round"]) == 8
    for a, b in zip(got["round"], want["round"]):
        assert {k: v for k, v in a.items() if k != "train_loss"} == \
            {k: v for k, v in b.items() if k != "train_loss"}
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=1e-5, atol=1e-5)
    assert [p["name"] for p in got["phase"]] == \
        [p["name"] for p in want["phase"]]
    assert [p.get("includes_compile") for p in got["phase"]] == \
        [p.get("includes_compile") for p in want["phase"]]
    host = ("total_comm_bytes", "total_latency_s", "total_energy_j")
    assert {c["name"]: c["value"] for c in got["counter"]
            if c["name"] in host} == \
        {c["name"]: c["value"] for c in want["counter"]
         if c["name"] in host}


# ------------------------------------------------------ lazy plane --
def _store_counter_events(events_path):
    prefix = "client_store_"
    evs = [e for e in read_events(events_path)
           if e["t"] == "counter" and e["name"].startswith(prefix)]
    order = [prefix + k for k in STORE_COUNTERS]
    assert [e["name"] for e in evs] == order * (len(evs) // len(order))
    return evs


@pytest.mark.parametrize("engine,capacity", [("eager", 5), ("scan", 9)])
def test_lazy_telemetry_on_is_bit_identical(fed, tmp_path, engine,
                                            capacity):
    res_off = _run(_make_trainer(fed, lazy=True, capacity=capacity),
                   engine=engine)
    with TelemetryRun(str(tmp_path / engine), seed=0) as tel:
        res_on = _run(_make_trainer(fed, lazy=True, capacity=capacity),
                      engine=engine, telemetry=tel)
    _assert_same(res_off, res_on)
    names = {e["name"] for e in _store_counter_events(tel.events_path)}
    assert names == {f"client_store_{k}" for k in STORE_COUNTERS}
    if engine == "scan":
        phases = [e["name"] for e in read_events(tel.events_path)
                  if e["t"] == "phase"]
        assert phases.count("ensure") == 2


def test_lazy_store_counters_match_oracle(fed, tmp_path):
    """The recorded per-round deltas equal an LRU-oracle replay of the
    schedule's raw padded zones (padding id 0 counts), and their totals
    the store's counters."""
    capacity, rounds = 5, 8
    tr = _make_trainer(fed, lazy=True, capacity=capacity)
    with TelemetryRun(str(tmp_path / "run"), seed=0) as tel:
        _run(tr, engine="eager", telemetry=tel, rounds=rounds)
    evs = _store_counter_events(tel.events_path)
    assert len(evs) == rounds * len(STORE_COUNTERS)
    got = [{k: evs[4 * r + j]["value"] for j, k in enumerate(STORE_COUNTERS)}
           for r in range(rounds)]
    totals = collections.Counter()
    for d in got:
        totals.update(d)
    assert dict(totals) == tr.store.counters
    assert totals["evictions"] > 0 and totals["restores"] > 0
    sched = _make_trainer(fed).schedule(rounds, np.random.default_rng(0))
    oracle: collections.OrderedDict = collections.OrderedDict()
    spilled: set = set()
    expect = []
    for r in range(rounds):
        uniq = list(dict.fromkeys(int(i) for i in sched.idx[r].reshape(-1)))
        missing = [i for i in uniq if i not in oracle]
        d = {"hits": len(uniq) - len(missing), "misses": len(missing),
             "evictions": 0, "restores": 0}
        need = len(missing) - (capacity - len(oracle))
        if need > 0:
            for v in [i for i in oracle if i not in set(uniq)][:need]:
                del oracle[v]
                spilled.add(v)
            d["evictions"] = need
        for i in missing:
            if i in spilled:
                d["restores"] += 1
                spilled.discard(i)
            oracle[i] = None
        for i in uniq:
            oracle.move_to_end(i)
        expect.append(d)
    assert got == expect
