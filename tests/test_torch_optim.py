"""The port's ``optim`` against the JAX package's ``repro.optim``.

The same gradients, drawn with numpy from a fixed seed, go through both
packages' ``sgd`` (plain, momentum, weight decay, a schedule) and
``adam`` (with and without weight decay) for 20 steps: params and state
agree at atol 1e-6 / rtol 1e-6 (fp32; the two frameworks may round
``b1 ** count`` and the square root one ulp apart). The schedules agree
at a range of counts at rtol 1e-6, and the reference's own optimizer
cases (``tests/test_optim_cnn.py``: convergence on the curved valley,
the schedules' values, weight decay) hold for the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro_torch import optim
from repro_torch.optim import adam, constant, cosine, sgd, step_decay
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-6, rtol=1e-6)
STEPS = 20
SHAPES = {"w": (5, 3), "b": (3,), "block": {"k": (4,)}}


def _tree(rng, shapes=SHAPES):
    return {k: _tree(rng, v) if isinstance(v, dict)
            else rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items()}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _assert_trees(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees(got[k], want[k])
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


CASES = {
    "sgd": lambda o: o.sgd(0.05),
    "sgd_momentum": lambda o: o.sgd(0.05, momentum=0.9),
    "sgd_weight_decay": lambda o: o.sgd(0.05, momentum=0.5,
                                        weight_decay=0.1),
    "sgd_step_decay": lambda o: o.sgd(o.step_decay(0.1, 0.5, every=3)),
    "adam": lambda o: o.adam(0.01),
    "adam_weight_decay": lambda o: o.adam(0.01, b1=0.8, b2=0.99, eps=1e-6,
                                          weight_decay=0.05),
    "adam_cosine": lambda o: o.adam(o.cosine(0.02, total_steps=15)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_reference(case):
    """20 steps of the same gradients: params, moments and counts."""
    rng = np.random.default_rng(sorted(CASES).index(case))
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    r_opt, opt = CASES[case](ref_optim), CASES[case](optim)
    r_params = jax.tree_util.tree_map(jnp.asarray, params)
    t_params = _to_torch(params)
    r_state, t_state = r_opt.init(r_params), opt.init(t_params)
    for g in grads:
        r_params, r_state = r_opt.update(
            jax.tree_util.tree_map(jnp.asarray, g), r_state, r_params)
        t_params, t_state = opt.update(_to_torch(g), t_state, t_params)
        _assert_trees(t_params, r_params)
    assert int(t_state["count"]) == int(r_state["count"]) == STEPS
    assert t_state["count"].dtype == torch.int32
    for key in set(r_state) - {"count"}:
        if r_state[key] is None:
            assert t_state[key] is None
        else:
            _assert_trees(t_state[key], r_state[key])


def test_update_writes_nothing_in_place():
    rng = np.random.default_rng(7)
    params = _to_torch(_tree(rng))
    before = {k: v.clone() for k, v in params.items() if k != "block"}
    for opt in (sgd(0.1, momentum=0.9, weight_decay=0.1), adam(0.1)):
        opt.update(_to_torch(_tree(rng)), opt.init(params), params)
        for k, v in before.items():
            assert torch.equal(params[k], v)


SCHEDULES = {
    "constant": lambda o: o.constant(0.1),
    "step_decay": lambda o: o.step_decay(1.0, decay=0.5, every=10),
    "step_decay_default": lambda o: o.step_decay(0.3),
    "cosine": lambda o: o.cosine(1.0, total_steps=100, final_frac=0.1),
    "cosine_short": lambda o: o.cosine(0.02, total_steps=7, final_frac=0.0),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    ref, port = SCHEDULES[name](ref_optim), SCHEDULES[name](optim)
    for count in (0, 1, 3, 7, 9, 10, 11, 50, 99, 100, 101, 1000):
        want = ref(jnp.asarray(count, jnp.int32))
        got = port(torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# The reference's own cases (tests/test_optim_cnn.py), on the port.
def _rosenbrock_ish(params):
    x, y = params["x"], params["y"]
    return ((1.0 - x) ** 2).sum() + 5.0 * ((y - x ** 2) ** 2).sum()


@pytest.mark.parametrize("opt_name,steps,tol", [
    ("sgd", 1500, 0.3),           # plain SGD is slow on the curved valley
    ("sgd_momentum", 500, 0.05),
    ("adam", 400, 0.05),
])
def test_optimizers_converge_on_quadratic(opt_name, steps, tol):
    opt = {
        "sgd": sgd(0.02),
        "sgd_momentum": sgd(0.02, momentum=0.9),
        "adam": adam(0.05),
    }[opt_name]
    params = {"x": torch.zeros(3), "y": torch.zeros(3)}
    state = opt.init(params)
    for _ in range(steps):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(
            _rosenbrock_ish(leaves), list(leaves.values()))))
        params, state = opt.update(grads, state, params)
    assert float(_rosenbrock_ish(params)) < tol


def test_schedules():
    assert float(constant(0.1)(torch.tensor(100))) == pytest.approx(0.1)
    sd = step_decay(1.0, decay=0.5, every=10)
    assert float(sd(torch.tensor(0))) == pytest.approx(1.0)
    assert float(sd(torch.tensor(10))) == pytest.approx(0.5)
    cs = cosine(1.0, total_steps=100, final_frac=0.1)
    assert float(cs(torch.tensor(0))) == pytest.approx(1.0)
    assert float(cs(torch.tensor(100))) == pytest.approx(0.1, abs=1e-6)
    assert float(cs(torch.tensor(50))) < 1.0


def test_weight_decay_shrinks_params():
    opt = sgd(0.1, weight_decay=0.1)
    params = {"w": torch.ones(4)}
    state = opt.init(params)
    params, state = opt.update({"w": torch.zeros(4)}, state, params)
    assert float(params["w"][0]) < 1.0
