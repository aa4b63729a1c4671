"""The sharded client plane (``fl/sharding.py``, ``mesh=`` on every
trainer) against the port's own meshless runs.

Every case runs in fresh processes on gloo ranks (``_torch_dist``): a
process group is global to a process. The problem is the reference's
``tests/test_sharded_plane.py``'s: 8 clients of a 400-image MLR split,
zone 4, batch 16, ``closed_form`` at β 10, ``lossy_links`` on the dense
graph backend, 8 rounds evaluated every 4, the lazy plane at capacity 8.

* One rank: a one-rank mesh is the identity. Dense and lazy, under
  ``eager``, ``scan`` and ``scan_fused``, round metrics and history are
  ``==`` to the meshless run's (the reference's
  ``test_single_device_mesh_is_identity``, held to the port's own dense
  run); FedAvg with ``mesh=`` likewise.
* 2 and 4 ranks: each rank holds n/world client rows (and capacity/world
  store rows); the end state gathered whole (x, z, y, κ, visited, the
  fleet's tokens), the round metrics and the evaluation equal the
  single-process run's bit for bit, for the single walker (dense and
  lazy) and the K = 3 fleet; prefetch on equals off. The lazy plane
  also runs where clients spill and come back (capacity 4 of 8 for the
  walker under ``scan``, a round a window; 8 of 16 for a fleet of two): its
  runs equal the single-process ones with the same restored bytes.
* The interface: a mesh needs a "data" axis, scalars replicate, and a
  leading axis that does not divide the world replicates.
"""
import pytest

from _torch_dist import run_ranks
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SETUP = """
import dataclasses
import numpy as np
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.data import factory_from_federated, make_image_dataset, \\
    pathological_split
from repro_torch.data.loader import build_federated
from repro_torch.fl.base import to_device_data
from repro_torch.fl.fleet_trainer import FleetRWSADMMTrainer
from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer
from repro_torch.fl.sharding import FLSharding
from repro_torch.fl.simulation import run_simulation
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.models.small import get_model
from repro_torch.scenarios import get_scenario_config

N = 8
imgs, labels = make_image_dataset(400, seed=0)


def problem(n):
    fed = build_federated(imgs, labels, pathological_split(labels, n, seed=0))
    return to_device_data(fed, "cpu"), factory_from_federated(fed)


PROBLEMS = {N: problem(N)}
dense, factory = PROBLEMS[N]
model = get_model("mlr", (28, 28, 1))
scen = dataclasses.replace(get_scenario_config("lossy_links"),
                           graph_backend="dense", neighbor_k_max=8)


def make(*, lazy=False, fleet=0, mesh=None, prefetch=False, capacity=N,
         n=N):
    kw = dict(zone_size=4, batch_size=16, solver="closed_form",
              scenario=scen, seed=0, mesh=mesh, device="cpu")
    if n not in PROBLEMS:
        PROBLEMS[n] = problem(n)
    data = PROBLEMS[n][1] if lazy else PROBLEMS[n][0]
    if lazy:
        kw.update(store_capacity=capacity, prefetch=prefetch)
    if fleet:
        return FleetRWSADMMTrainer(model, data, RWSADMMHparams(beta=10.0),
                                   n_walkers=fleet, sync_every=3, **kw)
    return RWSADMMTrainer(model, data, RWSADMMHparams(beta=10.0), **kw)


def run(tr, engine, rounds=8):
    return run_simulation(tr, rounds=rounds, eval_every=4, seed=0,
                          engine=engine)


def drive(tr, engine, rounds=8, window=8):
    # (end state, round metrics, evaluation) of ``rounds`` rounds, in
    # windows of ``window`` rounds
    rng = np.random.default_rng(0)
    st = tr.init_state(0)
    metrics = []
    if engine == "eager":
        for r in range(rounds):
            st, m = tr.round(st, r, rng)
            metrics.append(m)
    else:
        for r in range(0, rounds, window):
            sched = tr.schedule(window, rng, start_round=r)
            st, stacked = tr.run_chunk(st, sched, engine=engine)
            metrics += tr.chunk_round_metrics(sched, stacked, r)
    return st, metrics, tr.evaluate(st)


def end_state(tr, st):
    base = getattr(st, "base", st)
    out = [tr.whole_rows(base.clients.x), tr.whole_rows(base.clients.z),
           base.server.y, base.server.kappa, base.visited]
    if hasattr(st, "tokens"):
        out.append(st.tokens)
    return out


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))
"""

ONE = SETUP + """
init_group()
mesh = make_data_mesh()
out = {}
for lazy in (False, True):
    for engine in ("eager", "scan", "scan_fused"):
        r0 = run(make(lazy=lazy), engine)
        r1 = run(make(lazy=lazy, mesh=mesh), engine)
        out[f"{lazy}/{engine}"] = bool(
            r0.round_metrics == r1.round_metrics
            and r0.history == r1.history)
from repro_torch.baselines.fedavg import FedAvgTrainer
fa = [run_simulation(FedAvgTrainer(model, dense, clients_per_round=4,
                                   device="cpu", mesh=m),
                     rounds=3, eval_every=3, seed=0)
      for m in (None, FLSharding(mesh))]
out["fedavg"] = bool(fa[0].round_metrics == fa[1].round_metrics
                     and fa[0].history == fa[1].history)
emit(out)
"""


def test_one_rank_mesh_is_identity(tmp_path):
    (out,) = run_ranks(ONE, 1, tmp_path)
    assert out and all(out.values()), out


MANY = SETUP + """
init_group()
sh = FLSharding(make_data_mesh())
out = {"n_devices": sh.n_devices}
out["scalar_spec"] = list(sh.row_sharding(torch.zeros(())))
out["rows_spec"] = list(sh.row_sharding(torch.zeros(8, 3)))
out["ragged_spec"] = list(sh.row_sharding(torch.zeros(6, 3)))
from torch.distributed.device_mesh import DeviceMesh
try:
    FLSharding(DeviceMesh("cpu", list(range(WORLD)),
                          mesh_dim_names=("model",)))
    out["needs_data"] = False
except ValueError:
    out["needs_data"] = True
td = make(mesh=sh)
out["dense_rows"] = int(td.init_state(0).clients.x.shape[0])
tl = make(lazy=True, mesh=sh)
out["lazy_rows"] = int(tl.init_state(0).clients.x.shape[0])
out["lazy_data_rows"] = int(tl.store.data.x_train.shape[0])
for name, kw, engine in [("dense_eager", {}, "eager"),
                         ("dense_scan_fused", {}, "scan_fused"),
                         ("lazy_scan", {"lazy": True}, "scan"),
                         ("fleet_scan", {"fleet": 3}, "scan"),
                         ("fleet_lazy_eager", {"fleet": 3, "lazy": True},
                          "eager"),
                         # a window's working set fits the store: one
                         # zone (4 of 8 clients), two of 16
                         ("spill_scan", {"lazy": True, "capacity": 4},
                          "scan"),
                         ("fleet_spill_eager", {"fleet": 2, "lazy": True,
                                                "capacity": 8, "n": 16},
                          "eager")]:
    t0, t1 = make(**kw), make(mesh=sh, **kw)
    window = 1 if kw.get("capacity") else 8
    (s0, m0, e0), (s1, m1, e1) = (drive(t, engine, window=window)
                                  for t in (t0, t1))
    out[name] = same(end_state(t0, s0), end_state(t1, s1)) and m0 == m1
    out[name + "_eval"] = bool(e0 == e1)
    if kw.get("capacity"):
        # the store spilled and restored, the same bytes on every rank
        out[name + "_restored"] = [t0.store.restored_bytes,
                                   t1.store.restored_bytes]
        out[name + "_spill_rows"] = int(
            getattr(s1, "base", s1).clients.x.shape[0])
ts = [make(lazy=True, mesh=sh, prefetch=p) for p in (False, True)]
rs = [run(t, "scan") for t in ts]
out["prefetch"] = bool(rs[0].round_metrics == rs[1].round_metrics
                       and rs[0].history == rs[1].history)
emit(out)
"""


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_runs_equal_single_process(world, tmp_path):
    outs = run_ranks(MANY, world, tmp_path, timeout=400)
    for out in outs:
        assert out["n_devices"] == world
        assert out["scalar_spec"] == []
        assert out["rows_spec"] == ["data", None]
        assert out["ragged_spec"] == ([None, None] if 6 % world
                                      else ["data", None])
        assert out["needs_data"]
        assert out["dense_rows"] == 8 // world
        assert out["lazy_rows"] == out["lazy_data_rows"] == 8 // world
        for name in ("dense_eager", "dense_scan_fused", "lazy_scan",
                     "fleet_scan", "fleet_lazy_eager", "spill_scan",
                     "fleet_spill_eager", "prefetch"):
            assert out[name] is True, (name, out)
        for name in ("dense_eager", "dense_scan_fused", "lazy_scan",
                     "fleet_scan", "fleet_lazy_eager", "spill_scan",
                     "fleet_spill_eager"):
            assert out[name + "_eval"] is True, (name, out)
        for name in ("spill_scan", "fleet_spill_eager"):
            single, sharded = out[name + "_restored"]
            assert single > 0 and sharded == single, (name, out)
        assert out["spill_scan_spill_rows"] == 4 // world
        assert out["fleet_spill_eager_spill_rows"] == 8 // world
