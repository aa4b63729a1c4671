"""``repro_torch.core.rwsadmm`` against ``repro.core.rwsadmm``.

Same numpy inputs through both; fp32 at atol = rtol = 1e-6 (both follow
the same expression order, so only last-bit rounding may differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rwsadmm as R
from repro_torch.core import rwsadmm as T
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-6, rtol=1e-6)
HP = dict(beta=4.0, kappa=0.01, kappa_decay=0.99, epsilon=1e-3)


def _hp(mod):
    return mod.RWSADMMHparams(**HP)


def _arrays(shape, seed, k=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(k)]


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


def test_hparams_match():
    assert _hp(T).eps_half == _hp(R).eps_half
    assert T.RWSADMMHparams() == T.RWSADMMHparams(**{
        k: getattr(R.RWSADMMHparams(), k)
        for k in ("beta", "kappa", "kappa_decay", "epsilon")})


@pytest.mark.parametrize("shape", [(257,), (3, 129)])
def test_elementwise_updates(shape):
    y, x, z, g = _arrays(shape, seed=len(shape))
    x[..., :7] = y[..., :7]          # sgn(0) = 0 entries
    t = [torch.from_numpy(a) for a in (y, x, z, g)]
    kappa = np.float32(0.02)
    _close(T.x_update(*t, _hp(T)), R.x_update(y, x, z, g, _hp(R)))
    _close(T.z_update(t[1], t[0], t[2], _hp(T), torch.tensor(kappa)),
           R.z_update(x, y, z, _hp(R), jnp.float32(kappa)))
    _close(T.contribution(t[1], t[2], t[0], _hp(T)),
           R.contribution(x, z, y, _hp(R)))
    _close(T.subproblem_grad(t[1], t[0], t[2], t[3], _hp(T)),
           R.subproblem_grad(x, y, z, g, _hp(R)))
    _close(T.y_update(t[0], t[1], t[2], 8.0), R.y_update(y, x, z, 8.0))


def test_client_round_single_and_zone():
    y, x, z, g = _arrays((300,), seed=1)
    kappa = np.float32(0.005)
    (xn, zn), cn, co = T.client_round(
        T.ClientState(torch.from_numpy(x), torch.from_numpy(z)),
        torch.from_numpy(y), torch.from_numpy(g), _hp(T),
        torch.tensor(kappa))
    ref, rcn, rco = R.client_round(R.ClientState(x, z), y, g, _hp(R),
                                   jnp.float32(kappa))
    for a, b in ((xn, ref.x), (zn, ref.z), (cn, rcn), (co, rco)):
        _close(a, b)
    # Broadcast over a zone axis ≡ the reference's vmap over clients.
    _, xs, zs, gs = _arrays((5, 300), seed=2)
    (xn, zn), cn, co = T.client_round(
        T.ClientState(torch.from_numpy(xs), torch.from_numpy(zs)),
        torch.from_numpy(y), torch.from_numpy(gs), _hp(T),
        torch.tensor(kappa))
    ref, rcn, rco = jax.vmap(lambda c, gg: R.client_round(
        c, y, gg, _hp(R), jnp.float32(kappa)))(R.ClientState(xs, zs), gs)
    for a, b in ((xn, ref.x), (zn, ref.z), (cn, rcn), (co, rco)):
        _close(a, b)


def test_zone_round_masked():
    y = _arrays((400,), seed=3, k=1)[0]
    xs, zs, gs = _arrays((6, 400), seed=4, k=3)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    kappa = np.float32(0.01)
    new, y_new = T.zone_round_masked(
        T.ClientState(torch.from_numpy(xs), torch.from_numpy(zs)),
        torch.from_numpy(y), torch.from_numpy(gs), torch.from_numpy(mask),
        _hp(T), torch.tensor(kappa), 20.0)
    ref, ry = R.zone_round_masked(R.ClientState(xs, zs), y, gs, mask,
                                  _hp(R), jnp.float32(kappa), 20.0)
    _close(new.x, ref.x)
    _close(new.z, ref.z)
    _close(y_new, ry)
    assert np.array_equal(new.x.numpy()[4:], xs[4:])


def test_init_states_and_server_round_done():
    params = _arrays((50,), seed=5, k=1)[0]
    c, s = T.init_states_warm(torch.from_numpy(params), _hp(T), 4)
    rc, rs = R.init_states_warm({"w": params}, _hp(R), 4)
    assert np.array_equal(c.x.numpy(), np.asarray(rc.x["w"]))
    assert np.array_equal(c.z.numpy(), np.asarray(rc.z["w"]))
    assert np.array_equal(s.y.numpy(), np.asarray(rs.y["w"]))
    assert float(s.kappa) == float(rs.kappa) and int(s.round) == 0
    c0, s0 = T.init_states(torch.from_numpy(params), _hp(T), 4)
    assert c0.x.shape == (4, 50) and not c0.x.any() and not s0.y.any()
    y_new = torch.ones(50)
    s1 = T.server_round_done(s, y_new, _hp(T))
    r1 = R.server_round_done(rs, {"w": np.ones(50, np.float32)}, _hp(R))
    assert float(s1.kappa) == float(r1.kappa)
    assert int(s1.round) == int(r1.round) == 1
    assert s1.y is y_new
