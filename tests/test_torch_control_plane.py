"""The port's host control plane against the JAX package's: data,
partition, graphs, the degree walk and the zone schedule must be EXACTLY
equal for the same seeds (both are numpy on the host)."""
import jax
import numpy as np
import pytest

from repro.core.graph import DynamicGraph as RDynamicGraph
from repro.core.markov import degree_transition_matrix as r_degree_matrix
from repro.core.rwsadmm import RWSADMMHparams as RHP
from repro.data import make_image_dataset as r_images
from repro.data import pathological_split as r_split
from repro.data.loader import build_federated as r_build
from repro.fl.base import to_device_data as r_device
from repro.fl.rwsadmm_trainer import RWSADMMTrainer as RTrainer
from repro.models.small import make_mlr
from repro_torch.core.graph import DynamicGraph
from repro_torch.core.markov import RandomWalkServer, \
    degree_transition_matrix
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.data import build_federated, make_image_dataset, \
    pathological_split
from repro_torch.data.synthetic_images import make_cifar_like
from repro_torch.fl.base import to_device_data
from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer
from repro_torch.models.small import MLR
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPE = (8, 8, 1)


def _fed(pkg, n_clients=12, seed=0):
    images, split, build = ((r_images, r_split, r_build) if pkg == "ref"
                            else (make_image_dataset, pathological_split,
                                  build_federated))
    imgs, labels = images(500, shape=SHAPE, seed=seed)
    return build(imgs, labels, split(labels, n_clients, seed=seed),
                 seed=seed)


@pytest.mark.parametrize("seed", [0, 3])
def test_data_pipeline_arrays_equal(seed):
    a, b = _fed("ref", seed=seed), _fed("port", seed=seed)
    for name in ("x_train", "y_train", "mask_train", "x_test", "y_test",
                 "mask_test"):
        ra, pb = getattr(a, name), getattr(b, name)
        assert ra.dtype == pb.dtype and np.array_equal(ra, pb), name
    ri, rl = r_images(64, shape=(32, 32, 3), noise=0.6, seed=seed)
    pi, pl = make_cifar_like(64, seed=seed)
    assert np.array_equal(ri, pi) and np.array_equal(rl, pl)
    parts_r = r_split(rl, 5, seed=seed)
    parts_p = pathological_split(pl, 5, seed=seed)
    assert all(np.array_equal(x, y) for x, y in zip(parts_r, parts_p))


def test_dynamic_graph_equal():
    ref, port = RDynamicGraph(40, 5, 3, seed=7), DynamicGraph(40, 5, 3, seed=7)
    for g_r, g_p in zip(ref.schedule(10, include_current=True),
                        port.schedule(10, include_current=True)):
        assert np.array_equal(g_r.adjacency, g_p.adjacency)
        assert np.array_equal(g_r.positions, g_p.positions)
    assert ref.n_regens == port.n_regens


def test_degree_chain_rows_equal():
    graph = DynamicGraph(30, 5, 10, seed=2).current()
    p = degree_transition_matrix(graph)
    assert np.array_equal(p, r_degree_matrix(graph))
    for i in range(graph.n):
        assert np.array_equal(RandomWalkServer().transition_row(graph, i),
                              p[i])


def _trainers(seed, n_clients=12, zone=4):
    ref = RTrainer(make_mlr(SHAPE), r_device(_fed("ref", n_clients)),
                   RHP(beta=10.0), zone_size=zone, batch_size=5,
                   scenario=None, seed=seed)
    port = RWSADMMTrainer(MLR(SHAPE), to_device_data(_fed("port", n_clients),
                                                     "cpu"),
                          RWSADMMHparams(beta=10.0), zone_size=zone,
                          batch_size=5, seed=seed, device="cpu")
    return ref, port


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_schedule_columns_equal(seed):
    ref, port = _trainers(seed)
    rng_r, rng_p = (np.random.default_rng(seed) for _ in range(2))
    for start, rounds in ((0, 7), (7, 5)):      # two chained windows
        sr = ref.schedule(rounds, rng_r, start_round=start)
        sp = port.schedule(rounds, rng_p, start_round=start)
        for col in ("idx", "mask", "n_i", "clients", "active", "latency_s",
                    "energy_j"):
            a, b = getattr(sr, col), getattr(sp, col)
            assert a.dtype == b.dtype and np.array_equal(a, b), col
        assert np.array_equal(np.asarray(sr.keys).astype(np.int64),
                              sp.keys)
    assert ref.walker.hitting_time() == port.walker.hitting_time()
    assert np.array_equal(ref.walker.visit_counts, port.walker.visit_counts)


@pytest.mark.parametrize("seed", [0, 2])
def test_eager_round_host_metrics_equal(seed):
    ref, port = _trainers(seed)
    s_r = ref.init_state(jax.random.PRNGKey(0))
    s_p = port.init_state(0)
    rng_r, rng_p = (np.random.default_rng(seed) for _ in range(2))
    # scenario=None prices every round (static_regen's comm model), so
    # latency_s and energy_j are host columns like the rest.
    keys = ("round", "client", "zone", "n_i", "comm_bytes", "staleness_p50",
            "staleness_max", "latency_s", "energy_j")
    for r in range(8):
        s_r, m_r = ref.round(s_r, r, rng_r)
        s_p, m_p = port.round(s_p, r, rng_p)
        assert {k: m_r[k] for k in keys} == {k: m_p[k] for k in keys}
        assert type(m_p["staleness_max"]) is int
        assert set(m_r) == set(m_p)
