"""The walk layer of the port (``repro_torch.core.markov``'s chains and
walk policies, ``core.graph``'s helpers, ``data.partition``'s label
utilities, ``core.rwsadmm``'s theory diagnostics) against the JAX
package's, on the CPU.

The control plane is host numpy in both packages, so the chains, rows,
walks, importance weights and schedule columns are held by ``==``
(``np.array_equal``): the MH rows' ``min(inv_i, w_j·inv_j / w_i)``, the
scatter into a length-n row before ``1 − row.sum()`` and the visit's
``w.sum() / (n·w_i)`` are copied operation for operation, and a last-bit
difference in a row would move a walk. The diagnostics run in fp32 in
both packages and agree at 1e-6; ``beta_lower_bound`` is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as RG
from repro.core import markov as RM
from repro.core import rwsadmm as RR
from repro.core.rwsadmm import ClientState as RCS
from repro.core.rwsadmm import RWSADMMHparams as RHP
from repro.data import partition as RP
from repro_torch.core import graph as TG
from repro_torch.core import markov as TM
from repro_torch.core import rwsadmm as TR
from repro_torch.data import partition as TP
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

POLICIES = list(TM.WALK_POLICIES)
TOL = dict(atol=1e-6, rtol=1e-6)


def _graph_pair(g):
    """The same dense graph as each package's ``ClientGraph``."""
    return (RG.ClientGraph(adjacency=g.adjacency, positions=g.positions),
            TG.ClientGraph(adjacency=g.adjacency, positions=g.positions))


def _rgg(n, k, seed):
    return TG.random_geometric_graph(n, k, np.random.default_rng(seed))


# -------------------------------------------------------------- graphs --
def test_graph_helpers_equal_reference():
    """``degree``, ``neighbors``, ``is_connected`` on both backends, and
    ``line_graph``/``complete_graph``, equal the reference's."""
    for g in (_rgg(30, 5, 0), TG.line_graph(9), TG.complete_graph(7)):
        r, t = _graph_pair(g)
        assert np.array_equal(r.degree(), t.degree())
        assert r.degree(3) == t.degree(3)
        assert r.is_connected() == t.is_connected() is True
        for i in range(g.n):
            assert np.array_equal(r.neighbors(i), t.neighbors(i))
        rs, ts = RG.neighbor_graph_from_dense(r), TG.neighbor_graph_from_dense(t)
        assert np.array_equal(rs.degree(), ts.degree())
        assert rs.degree(2) == ts.degree(2)
        assert rs.is_connected() == ts.is_connected() is True
    split = np.zeros((6, 6), bool)
    split[0, 1] = split[1, 0] = True
    g = TG.ClientGraph(adjacency=split, positions=np.zeros((6, 2)))
    assert not g.is_connected()
    assert not TG.neighbor_graph_from_dense(g).is_connected()
    for n in (2, 9, 21):
        for name in ("line_graph", "complete_graph"):
            a, b = getattr(RG, name)(n), getattr(TG, name)(n)
            assert np.array_equal(a.adjacency, b.adjacency)
            assert np.array_equal(a.positions, b.positions)


# -------------------------------------------------------------- chains --
@pytest.mark.parametrize("case", ["rgg_sparse", "rgg_dense", "complete21",
                                  "complete45", "line"])
def test_chain_matrices_equal_reference(case):
    """``metropolis_transition_matrix`` and ``biased_transition_matrix``
    by ``np.array_equal``. Complete graphs of 21 and 46 clients make
    every row's off-diagonal sum round to 1 + 2⁻⁵², so the self-loop
    clamp to 0 runs (checked); the biased chain runs under random
    weights, under weights that make every neighbor's term 1/deg(i)
    (the clamp again), and under w ≡ 1, where it is the Metropolis
    chain."""
    g = {"rgg_sparse": _rgg(40, 5, 1), "rgg_dense": _rgg(40, 15, 2),
         "complete21": TG.complete_graph(21),
         "complete45": TG.complete_graph(46),
         "line": TG.line_graph(12)}[case]
    r, t = _graph_pair(g)
    p = TM.metropolis_transition_matrix(t)
    assert np.array_equal(p, RM.metropolis_transition_matrix(r))
    if case.startswith("complete"):
        off = p - np.diag(np.diag(p))
        assert (off.sum(axis=1) > 1.0).any() and (np.diag(p) == 0.0).any()
    rng = np.random.default_rng(3)
    for w in (rng.uniform(0.1, 5.0, g.n), np.ones(g.n),
              1.0 + np.arange(g.n, dtype=np.float64) ** 3):
        b = TM.biased_transition_matrix(t, w)
        assert np.array_equal(b, RM.biased_transition_matrix(r, w))
        assert np.all(b >= 0) and np.allclose(b.sum(axis=1), 1.0)
    assert np.array_equal(TM.biased_transition_matrix(t, np.ones(g.n)), p)


def _walker_pair(policy, graph_pair, seed=5, steps=7, label_w=None):
    """A reference and a port walker of ``policy`` from the same seed,
    stepped ``steps`` times on the dense graph (so the staleness weights
    are not all equal)."""
    out = []
    for markov, g in zip((RM, TM), graph_pair):
        w = markov.RandomWalkServer(seed=seed, policy=policy, bias_gamma=0.5)
        w.set_label_weights(label_w)
        w.reset(g)
        for _ in range(steps):
            w.step(g)
        out.append(w)
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_rows_equal_reference_on_both_backends(policy):
    """``transition_row`` on both backends and ``_sparse_row`` for every
    policy and node equal the reference walker's in the same state, and
    the dense and sparse rows are one row."""
    g = _rgg(36, 6, 4)
    pair = _graph_pair(g)
    label_w = np.random.default_rng(1).uniform(0.2, 3.0, g.n)
    ref, port = _walker_pair(policy, pair, label_w=label_w)
    assert np.array_equal(ref.policy_weights(g.n), port.policy_weights(g.n))
    assert np.array_equal(ref.stationary_target(g.n),
                          port.stationary_target(g.n))
    r_sp, t_sp = (mod.neighbor_graph_from_dense(x)
                  for mod, x in zip((RG, TG), pair))
    for i in range(g.n):
        row = port.transition_row(pair[1], i)
        assert np.array_equal(row, ref.transition_row(pair[0], i))
        assert np.array_equal(port.transition_row(t_sp, i), row)
        assert np.array_equal(ref.transition_row(r_sp, i), row)
        c_r, p_r = ref._sparse_row(r_sp, i)
        c_t, p_t = port._sparse_row(t_sp, i)
        assert np.array_equal(c_r, c_t) and np.array_equal(p_r, p_t)
    if policy != "degree":
        assert np.array_equal(port.matrix(pair[1]), ref.matrix(pair[0]))


# --------------------------------------------------------------- walks --
@pytest.mark.parametrize("backend", ["dense", "sparse"])
@pytest.mark.parametrize("policy", POLICIES)
def test_walks_equal_reference(policy, backend):
    """60 moves over a regenerating graph, by ``step`` and then by
    ``walk_schedule_batched`` in two windows: positions,
    ``weight_history`` and ``hitting_time`` equal the reference's."""
    label_w = np.random.default_rng(2).uniform(0.2, 3.0, 25)
    runs = []
    for graph, markov in ((RG, RM), (TG, TM)):
        dyn = graph.DynamicGraph(25, 4, 7, seed=9)
        graphs = dyn.schedule(60, include_current=True)
        if backend == "sparse":
            graphs = [graph.neighbor_graph_from_dense(x) for x in graphs]
        out = []
        for batched in (False, True):
            w = markov.RandomWalkServer(seed=3, policy=policy, bias_gamma=0.5)
            w.set_label_weights(label_w)
            w.reset(graphs[0])
            if batched:
                pos = np.concatenate([
                    w.walk_schedule_batched(graphs[:30], advance_first=False),
                    w.walk_schedule_batched(graphs[30:])])
            else:
                pos = np.array([w.step(x) for x in graphs[1:]])
            out.append((pos, list(w.weight_history), w.hitting_time(),
                        w.walk_weights(20)))
        runs.append(out)
    for (pos_r, iw_r, hit_r, ww_r), (pos_t, iw_t, hit_t, ww_t) in zip(*runs):
        assert np.array_equal(pos_r, pos_t)
        assert iw_r == iw_t and hit_r == hit_t
        assert (ww_r is None) == (ww_t is None)
        if ww_t is not None:
            assert np.array_equal(ww_r, ww_t)
            assert len(set(iw_t)) > 1    # the weights really move
        else:
            assert set(iw_t) == {1.0}


def test_walker_rules_equal_reference():
    """``__post_init__``'s rules: a uniform policy sets the transition,
    an unknown one is refused; label weights must be positive and are
    mean-normalized; their length must match the graph."""
    for markov in (RM, TM):
        w = markov.RandomWalkServer(transition="degree", policy="metropolis")
        assert (w.transition, w.policy, w.is_biased) == ("metropolis",
                                                         "metropolis", False)
        w = markov.RandomWalkServer(transition="metropolis")
        assert w.policy == "metropolis"
        assert markov.RandomWalkServer(policy="staleness").is_biased
        with pytest.raises(ValueError, match="unknown walk policy"):
            markov.RandomWalkServer(policy="random")
        w = markov.RandomWalkServer(policy="label_skew")
        with pytest.raises(ValueError, match="strictly positive"):
            w.set_label_weights(np.array([1.0, 0.0]))
        w.set_label_weights(np.array([1.0, 3.0]))
        assert np.array_equal(w.label_weights, [0.5, 1.5])
        with pytest.raises(ValueError, match="length"):
            w.policy_weights(3)
    assert TM.WALK_POLICIES == RM.WALK_POLICIES
    assert TM.BIASED_POLICIES == RM.BIASED_POLICIES


# ----------------------------------------------------------- schedules --
def _price(graphs, clients, idx, mask):
    """A deterministic stand-in price: what the columns carry through."""
    return (mask.sum(axis=-1).astype(np.float64) * 0.5,
            np.asarray(clients, np.float64).reshape(len(graphs), -1).sum(1))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_zone_schedule_iw_equals_reference(policy, batched):
    """Two windows of ``zone_schedule`` across regenerations: every
    column, ``iw`` included, by ``==``."""
    label_w = np.random.default_rng(4).uniform(0.2, 3.0, 30)
    runs = []
    for graph, markov in ((RG, RM), (TG, TM)):
        dyn = graph.DynamicGraph(30, 5, 6, seed=1)
        w = markov.RandomWalkServer(seed=2, policy=policy, bias_gamma=0.5)
        w.set_label_weights(label_w)
        w.reset(dyn.current())
        rng = np.random.default_rng(3)
        runs.append([markov.zone_schedule(dyn, w, 9, 4, rng, start_round=s,
                                          price=_price, batched_walk=batched)
                     for s in (0, 9)])
    for ref, port in zip(*runs):
        for col in ("idx", "mask", "n_i", "clients", "active", "latency_s",
                    "energy_j", "iw"):
            a, b = getattr(ref, col), getattr(port, col)
            assert (a is None) == (b is None), col
            if b is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), col
        assert np.array_equal(np.asarray(ref.keys).astype(np.int64),
                              port.keys)
    assert (runs[1][0].iw is None) == (policy not in TM.BIASED_POLICIES)


@pytest.mark.parametrize("mode", ["roundrobin", "simultaneous"])
@pytest.mark.parametrize("policy", ["staleness", "label_skew", "metropolis"])
def test_fleet_schedule_iw_equals_reference(policy, mode):
    """Three windows of the K = 3 fleet schedule across regenerations
    (the round-robin fleet's parked rounds in the first): every column,
    ``iw`` ((R,) or (R, K)) included, by ``==``."""
    label_w = np.random.default_rng(5).uniform(0.2, 3.0, 40)
    runs = []
    for graph, markov in ((RG, RM), (TG, TM)):
        dyn = graph.DynamicGraph(40, 5, 5, seed=6)
        walkers = []
        for k in range(3):
            w = markov.RandomWalkServer(seed=7 + 10 * k, policy=policy,
                                        bias_gamma=0.5)
            w.set_label_weights(label_w)
            w.reset(dyn.current())
            walkers.append(w)
        rng = np.random.default_rng(8)
        kw = dict(sync_every=4, mode=mode)
        if mode == "roundrobin":
            kw["price"] = _price
        else:
            kw["price_fleet"] = lambda g, c, i, m: (m.sum(-1) * 0.5,
                                                    c.astype(float))
        runs.append([markov.fleet_zone_schedule(dyn, walkers, 6, 4, rng,
                                                start_round=s, **kw)
                     for s in (0, 6, 12)])
    for ref, port in zip(*runs):
        cols = ["idx", "mask", "n_i", "clients", "active", "sync", "iw",
                "latency_s", "energy_j"]
        cols += (["walker"] if mode == "roundrobin"
                 else ["latency_s_walkers", "energy_j_walkers"])
        for col in cols:
            a, b = getattr(ref, col), getattr(port, col)
            assert (a is None) == (b is None), col
            if b is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), col
    if policy != "metropolis":
        shape = (6,) if mode == "roundrobin" else (6, 3)
        assert runs[1][2].iw.shape == shape


# ------------------------------------------------------------ partition --
def test_partition_helpers_equal_reference():
    """``dirichlet_split`` (with the top-up), both histogram helpers and
    ``label_skew_weights`` equal the reference's exactly."""
    labels = np.random.default_rng(0).integers(0, 10, 900)
    for alpha, n, floor in ((0.3, 12, 8), (0.05, 30, 40)):
        ref = RP.dirichlet_split(labels, n, alpha=alpha,
                                 min_per_client=floor, seed=4)
        port = TP.dirichlet_split(labels, n, alpha=alpha,
                                  min_per_client=floor, seed=4)
        assert len(ref) == len(port) == n
        assert all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(ref, port))
        assert min(len(p) for p in port) >= floor
        hist = TP.client_label_histograms(labels, port)
        assert np.array_equal(hist, RP.client_label_histograms(labels, ref))
        for gamma in (0.5, 1.0, 2.0):
            assert np.array_equal(TP.label_skew_weights(hist, gamma=gamma),
                                  RP.label_skew_weights(hist, gamma=gamma))
    y = np.random.default_rng(1).integers(0, 7, (9, 20))
    valid = np.random.default_rng(2).integers(1, 21, 9)
    for n_classes in (None, 10):
        assert np.array_equal(
            TP.padded_label_histograms(y, valid, n_classes),
            RP.padded_label_histograms(y, valid, n_classes))


# ---------------------------------------------------------- diagnostics --
def test_diagnostics_equal_reference():
    """``x_update(literal_eq11=True)`` (inert from Eq. 32's init),
    ``zone_round``, ``augmented_lagrangian``, ``lyapunov_m``,
    ``constraint_violation`` and ``pairwise_violation`` at 1e-6 on the
    same numpy-seeded inputs; ``beta_lower_bound`` exactly."""
    rng = np.random.default_rng(0)
    n, p = 6, 33
    x, z, g = (rng.standard_normal((n, p)).astype(np.float32)
               for _ in range(3))
    y = rng.standard_normal(p).astype(np.float32)
    losses = rng.uniform(0, 3, n).astype(np.float32)
    adj = RG.random_geometric_graph(n, 2, np.random.default_rng(1)).adjacency
    dsq = rng.uniform(0, 1, n).astype(np.float32)
    hp_r, hp_t = RHP(beta=10.0, epsilon=1e-3), TR.RWSADMMHparams(
        beta=10.0, epsilon=1e-3)
    t = {k: torch.as_tensor(v) for k, v in
         dict(x=x, z=z, g=g, y=y, losses=losses, dsq=dsq).items()}

    for lit in (False, True):
        got = TR.x_update(t["y"], t["x"], t["z"], t["g"], hp_t,
                          literal_eq11=lit)
        want = RR.x_update(jnp.asarray(y), jnp.asarray(x), jnp.asarray(z),
                           jnp.asarray(g), hp_r, literal_eq11=lit)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    moved = TR.x_update(t["y"], t["y"], torch.zeros_like(t["y"]), t["g"][0],
                        hp_t, literal_eq11=True) - t["y"]
    assert float(moved.abs().max()) == 0.0

    new, y_new = TR.zone_round(TR.ClientState(t["x"], t["z"]), t["y"],
                               t["g"], hp_t, 0.01, float(n * 3))
    r_new, r_y = RR.zone_round(RCS(x=jnp.asarray(x), z=jnp.asarray(z)),
                               jnp.asarray(y), jnp.asarray(g), hp_r, 0.01,
                               float(n * 3))
    for a, b in ((new.x, r_new.x), (new.z, r_new.z), (y_new, r_y)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    l_t = TR.augmented_lagrangian(t["y"], TR.ClientState(t["x"], t["z"]),
                                  t["losses"], hp_t)
    l_r = RR.augmented_lagrangian(jnp.asarray(y), RCS(x=jnp.asarray(x),
                                                      z=jnp.asarray(z)),
                                  jnp.asarray(losses), hp_r)
    np.testing.assert_allclose(float(l_t), float(l_r), **TOL)
    np.testing.assert_allclose(
        float(TR.lyapunov_m(l_t, t["dsq"], 2.5, n)),
        float(RR.lyapunov_m(l_r, jnp.asarray(dsq), 2.5, n)), **TOL)
    np.testing.assert_allclose(
        float(TR.constraint_violation(t["y"], t["x"], hp_t)),
        float(RR.constraint_violation(jnp.asarray(y), jnp.asarray(x), hp_r)),
        **TOL)
    np.testing.assert_allclose(
        float(TR.pairwise_violation(t["x"], torch.as_tensor(adj), hp_t)),
        float(RR.pairwise_violation(jnp.asarray(x), jnp.asarray(adj), hp_r)),
        **TOL)
    for lip in (0.0, 1.0, 3.7):
        assert TR.beta_lower_bound(lip) == RR.beta_lower_bound(lip)
