"""The first slice end to end on the CPU: the port's RWSADMM trainer
against a zone round assembled from the JAX package's own functions.

Both sides start from the same initial params (the reference MLP's init,
carried over with ``convert``) and see the same zones and the same
minibatch indices (the port's threefry draws, injected into the
reference's round).
Tolerance atol = rtol = 1e-6 on x, z, y after every round (the gap seen
is ~2e-7): per-client gradients differ in the last bits (matmul
summation order), and each round feeds those bits into the next
gradients. κ is equal bit for
bit (the same fp32 products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rwsadmm as R
from repro.core import tree as rtree
from repro.kernels.rwsadmm_update.ops import rwsadmm_zone_fused_update
from repro.models import small as RS
from repro_torch import convert
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.data import build_federated, make_image_dataset, \
    pathological_split
from repro_torch.fl.base import to_device_data, validate_round_metrics
from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer
from repro_torch.fl.simulation import run_simulation
from repro_torch.models.small import MLP
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPE, N_CLIENTS, ZONE, ROUNDS = (8, 8, 1), 8, 4, 5
HP = dict(beta=10.0, kappa=0.01, epsilon=1e-3)
TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def fed():
    imgs, labels = make_image_dataset(300, shape=SHAPE, seed=0)
    return build_federated(imgs, labels,
                           pathological_split(labels, N_CLIENTS, seed=0))


def _port(fed, solver, seed=0, min_degree=5):
    return RWSADMMTrainer(MLP(SHAPE, hidden=16), to_device_data(fed, "cpu"),
                          RWSADMMHparams(**HP), zone_size=ZONE,
                          batch_size=6, solver=solver, inner_steps=3,
                          inner_lr=0.05, min_degree=min_degree, seed=seed,
                          device="cpu")


class JaxReference:
    """One dense-plane zone round built from ``repro`` functions: value
    and grad of the model's loss (``train=False``), the closed-form zone
    update through the Pallas kernel (interpret mode) or the prox-SGD
    inner loop, the masked y fold and the masked scatter-back."""

    def __init__(self, fed, params, solver, inner_steps, inner_lr):
        self.model = RS.make_mlp(SHAPE, hidden=16)
        self.template = params
        self.hp = R.RWSADMMHparams(**HP)
        self.solver, self.k, self.eta = solver, inner_steps, inner_lr
        self.x_train, self.y_train = fed.x_train, fed.y_train
        flat = rtree.flatten(params)
        self.X = jnp.tile(flat[None], (N_CLIENTS, 1))
        self.Z = jnp.zeros_like(self.X)
        self.y = flat
        self.kappa = jnp.float32(HP["kappa"])

        def loss(f, xb, yb):
            p = rtree.unflatten(self.template, f)
            return RS.cross_entropy(self.model.apply(p, xb, train=False), yb)

        self.vg = jax.vmap(jax.value_and_grad(loss))

    def round(self, idx, mask, bidx):
        hp, n = self.hp, float(N_CLIENTS)
        ax, az = self.X[idx], self.Z[idx]
        batch = lambda b: (self.x_train[idx[:, None], b],
                           self.y_train[idx[:, None], b])
        if self.solver == "closed_form":
            _, g = self.vg(ax, *batch(bidx))
            xn, zn, yn = rwsadmm_zone_fused_update(
                ax, az, self.y, g, mask, self.kappa, beta=hp.beta,
                eps_half=hp.eps_half, n_total=n)
        else:
            xn = ax
            for k in range(self.k):
                _, gf = self.vg(xn, *batch(bidx[k]))
                xn = xn - self.eta * R.subproblem_grad(xn, self.y, az, gf, hp)
            zn = R.z_update(xn, self.y, az, hp, self.kappa)
            cn = R.contribution(xn, zn, self.y, hp)
            co = R.contribution(ax, az, self.y, hp)
            yn = self.y + jnp.sum(mask[:, None] * (cn - co), axis=0) / n
        m = mask[:, None]
        self.X = self.X.at[idx].add(m * (xn - ax))
        self.Z = self.Z.at[idx].add(m * (zn - az))
        self.y = yn
        self.kappa = self.kappa * hp.kappa_decay


def _init_params():
    return jax.tree_util.tree_map(
        np.asarray, RS.make_mlp(SHAPE, hidden=16).init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("min_degree", [5, 1])   # 1: zones with padding
@pytest.mark.parametrize("solver,fused", [("closed_form", False),
                                          ("closed_form", True),
                                          ("prox_sgd", False)])
def test_trajectory_matches_jax_reference(fed, solver, fused, min_degree):
    params = _init_params()
    port = _port(fed, solver, min_degree=min_degree)
    state = port.init_state(params=convert.flat_from_reference(
        params, port.layout))
    ref = JaxReference(fed, params, solver, port.inner_steps, port.inner_lr)
    sched = port.schedule(ROUNDS, np.random.default_rng(0))
    assert (sched.mask == 0).any() == (min_degree == 1)
    steps = None if solver == "closed_form" else port.inner_steps
    for r in range(ROUNDS):
        idx = torch.as_tensor(sched.idx[r], dtype=torch.int64)
        mask = torch.as_tensor(sched.mask[r])
        key = torch.as_tensor(sched.keys[r])
        bidx, keep = port.zone_batch_indices(idx, key, steps)
        state, _ = port._round_impl(state, idx, mask, key,
                                    use_fused=fused, batch_idx=bidx)
        ref.round(sched.idx[r], sched.mask[r], bidx.numpy())
        np.testing.assert_allclose(state.clients.x.numpy(), ref.X, **TOL)
        np.testing.assert_allclose(state.clients.z.numpy(), ref.Z, **TOL)
        np.testing.assert_allclose(state.server.y.numpy(), ref.y, **TOL)
        assert float(state.server.kappa) == float(ref.kappa)
    assert bool(state.visited[sched.idx[sched.mask > 0]].all())


def test_round_samples_what_it_would_inject(fed):
    """``_round_impl`` without injected indices draws exactly the batch
    ``zone_batch_indices`` returns for the same key."""
    a, b = _port(fed, "closed_form"), _port(fed, "closed_form")
    sa, sb = a.init_state(0), b.init_state(0)
    idx, mask = torch.tensor([3, 1, 4, 0]), torch.tensor([1., 1., 1., 0.])
    bidx, _ = b.zone_batch_indices(idx, b.round_key(1234))
    sa, la = a._round_impl(sa, idx, mask, a.round_key(1234))
    sb, lb = b._round_impl(sb, idx, mask, b.round_key(999), batch_idx=bidx)
    assert torch.equal(sa.clients.x, sb.clients.x) and torch.equal(la, lb)
    n_tr = b.data.n_train[idx].unsqueeze(-1)
    assert bool((bidx >= 0).all() and (bidx < n_tr).all())


def _eager_states(trainer, rounds, seed):
    rng = np.random.default_rng(seed)
    state, metrics = trainer.init_state(seed), []
    for r in range(rounds):
        state, m = trainer.round(state, r, rng)
        metrics.append(m)
    return state, metrics


@pytest.mark.parametrize("solver", ["closed_form", "prox_sgd"])
def test_eager_equals_scan_bitwise(fed, solver):
    s_e, m_e = _eager_states(_port(fed, solver), 7, seed=4)
    port = _port(fed, solver)
    rng = np.random.default_rng(4)
    state = port.init_state(4)
    m_s = []
    for start, rounds in ((0, 3), (3, 4)):
        sched = port.schedule(rounds, rng, start_round=start)
        state, stacked = port.run_chunk(state, sched, "scan")
        m_s += port.chunk_round_metrics(sched, stacked, start)
    assert m_e == m_s
    for a, b in ((s_e.clients.x, state.clients.x),
                 (s_e.clients.z, state.clients.z),
                 (s_e.server.y, state.server.y),
                 (s_e.visited, state.visited)):
        assert torch.equal(a, b)


def test_scan_fused_matches_scan(fed):
    runs = {}
    for engine in ("scan", "scan_fused"):
        port = _port(fed, "closed_form")
        rng = np.random.default_rng(2)
        state = port.init_state(2)
        state, stacked = port.run_chunk(state, port.schedule(6, rng), engine)
        runs[engine] = (state, stacked)
    (a, la), (b, lb) = runs["scan"], runs["scan_fused"]
    for u, v in ((a.clients.x, b.clients.x), (a.clients.z, b.clients.z),
                 (a.server.y, b.server.y), (la["train_loss"],
                                            lb["train_loss"])):
        torch.testing.assert_close(u, v, atol=1e-6, rtol=1e-6)


def test_run_simulation_engines(fed):
    results = {engine: run_simulation(
        _port(fed, "closed_form"), rounds=7, eval_every=3, seed=1,
        engine=engine) for engine in ("eager", "scan", "scan_fused")}
    keys = {e: validate_round_metrics(r.round_metrics)
            for e, r in results.items()}
    assert keys["eager"] == keys["scan"] == keys["scan_fused"]
    assert results["eager"].round_metrics == results["scan"].round_metrics
    assert results["eager"].history == results["scan"].history
    assert [h["round"] for h in results["scan_fused"].history] == [3, 6, 7]
    for h in results["scan_fused"].history:
        assert 0.0 <= h["acc_personalized"] <= 1.0
    with pytest.raises(ValueError, match="closed_form"):
        run_simulation(_port(fed, "prox_sgd"), rounds=2,
                       engine="scan_fused")
