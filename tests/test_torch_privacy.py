"""DP uploads in the port (``core/privacy.py``, ``prng.normal``) against
the reference's.

``prng.normal`` draws the reference's uniform bits exactly and scales,
shifts and clamps them as ``jax.random.normal`` does; only erf⁻¹ differs:
the port evaluates XLA's single-precision polynomial with torch's
``log1p``, which rounds its own way, and the normals read at most
``NORMAL_ULP`` ulp from JAX's (observed: 3 ulp on 5 % of the values of
200,000 draws; 0 on the rest). ``clip_tree`` sums the squares in another
order than XLA, so clipped deltas agree to rounding. One DP round of each
RWSADMM trainer against the reference's at the round tier's 1e-6, DP on
the lazy plane ≡ dense, and the refusals of ``scan_fused`` and the
simultaneous fleet (the card's checks are in
``tests/test_torch_lazy_card.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import privacy as r_privacy
from repro_torch import convert
from repro_torch.core import privacy, prng
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.core.tree import ParamLayout
from repro_torch.data import build_federated, factory_from_federated, \
    make_image_dataset, pathological_split
from repro_torch.fl import FleetRWSADMMTrainer, RWSADMMTrainer, \
    to_device_data
from repro_torch.fl.simulation import run_simulation
from repro_torch.models.small import get_model
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: the largest gap between ``prng.normal`` and ``jax.random.normal``
NORMAL_ULP = 4
SHAPE, N_CLIENTS, ZONE, BATCH = (8, 8, 1), 10, 4, 6
HP = dict(beta=10.0, kappa=0.01, epsilon=1e-3)
TOL = dict(atol=1e-6, rtol=1e-6)
DP = dict(dp_clip=1.0, dp_noise=1.0)


def _ulp_gap(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("seed,shape", [(0, (1000,)), (7, (50, 40)),
                                        (123, (200_000,)), (5, (3, 4, 5))])
def test_normal_matches_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.prng_key(seed), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    assert _ulp_gap(got, want) <= NORMAL_ULP


def test_normal_batches_keys_like_vmap():
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (5, 6)))(keys))
    got = prng.normal(prng.split(prng.prng_key(3), 4), (5, 6)).numpy()
    assert _ulp_gap(got, want) <= NORMAL_ULP


def test_erf_inv_edges():
    u = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999, 0.999999])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u.numpy())))
    got = prng.erf_inv(u).numpy()
    assert np.isinf(got[:2]).all() and np.sign(got[:2]).tolist() == [-1, 1]
    assert _ulp_gap(got[2:], want[2:]) <= NORMAL_ULP


def _deltas(layout, m, seed):
    rng = np.random.default_rng(seed)
    c_new = rng.normal(size=(m, layout.size)).astype(np.float32)
    c_old = rng.normal(size=(m, layout.size)).astype(np.float32)
    return c_new, c_old


def _tree(layout, row):
    """A flat row as the reference's parameter dict (nested by name)."""
    out: dict = {}
    for name, shape, off, size in zip(layout.names, layout.shapes,
                                      layout.offsets, layout.sizes):
        *path, leaf = name.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(row[off:off + size].reshape(shape))
    return out


def _flat(tree) -> torch.Tensor:
    return convert._flat_rows(jax.tree_util.tree_map(np.asarray, tree), 0)


@pytest.mark.parametrize("kind", ["mlr", "cnn"])
@pytest.mark.parametrize("clip", [0.5, 100.0])
def test_clip_and_privatize_match_the_reference(kind, clip):
    """``clip_tree`` and ``privatize_delta`` row by row against the
    reference on its parameter pytree: the clip to rounding, the noise
    per leaf in layout order within ``NORMAL_ULP`` of a draw."""
    model = (get_model(kind, SHAPE) if kind == "mlr"
             else get_model("cnn", (32, 32, 3)))
    layout = ParamLayout.from_module(model)
    c_new, c_old = _deltas(layout, 3, seed=1)
    keys = prng.split(prng.prng_key(11), 3)
    got_clip = privacy.clip_tree(torch.as_tensor(c_new - c_old), clip)
    got = privacy.privatize_delta(keys, torch.as_tensor(c_new),
                                  torch.as_tensor(c_old), layout, clip=clip,
                                  noise_multiplier=0.7).numpy()
    r_keys = jax.random.split(jax.random.PRNGKey(11), 3)
    for j in range(3):
        want_clip = _flat(r_privacy.clip_tree(
            _tree(layout, c_new[j] - c_old[j]), clip))
        np.testing.assert_allclose(got_clip[j].numpy(), want_clip.numpy(),
                                   rtol=1e-6, atol=1e-7)
        want = _flat(r_privacy.privatize_delta(
            r_keys[j], _tree(layout, c_new[j]), _tree(layout, c_old[j]),
            clip=clip, noise_multiplier=0.7))
        np.testing.assert_allclose(got[j], want.numpy(), rtol=1e-5,
                                   atol=1e-6 * max(clip, 1.0))
    if clip < 1.0:
        norms = torch.linalg.vector_norm(got_clip, dim=-1)
        assert torch.all(norms <= clip * (1 + 1e-6))


@pytest.mark.parametrize("sigma,visits,delta", [
    (1.0, 1, 1e-5), (1.0, 100, 1e-5), (0.5, 10, 1e-6), (4.0, 1000, 1e-5),
    (0.0, 10, 1e-5), (0.05, 1, 1e-5)])
def test_epsilon_advanced_composition_equals_the_reference(sigma, visits,
                                                           delta):
    got = privacy.epsilon_advanced_composition(sigma, visits, delta)
    want = r_privacy.epsilon_advanced_composition(sigma, visits, delta)
    assert got == want or (math.isinf(got) and math.isinf(want))


# ------------------------------------------------------------- DP rounds --
def _fed(pkg):
    if pkg == "ref":
        from repro.data import make_image_dataset as images
        from repro.data import pathological_split as split
        from repro.data.loader import build_federated as build
    else:
        images, split, build = (make_image_dataset, pathological_split,
                                build_federated)
    imgs, labels = images(300, shape=SHAPE, seed=0)
    return build(imgs, labels, split(labels, N_CLIENTS, seed=0), seed=0)


@pytest.fixture(scope="module")
def feds():
    from repro.fl.base import to_device_data as r_device

    return r_device(_fed("ref")), to_device_data(_fed("port"), "cpu")


@pytest.mark.parametrize("fleet,solver", [(False, "closed_form"),
                                          (False, "prox_sgd"),
                                          (True, "closed_form")])
def test_dp_round_matches_the_reference(feds, fleet, solver):
    """Three eager DP rounds of each package from the same weights: the
    same zones, x/z/y (the tokens for the fleet) within 1e-6."""
    from repro.core.rwsadmm import RWSADMMHparams as RHP
    from repro.fl.fleet_trainer import FleetRWSADMMTrainer as RFleet
    from repro.fl.rwsadmm_trainer import RWSADMMTrainer as RTrainer
    from repro.models import small as RS

    kw = dict(zone_size=ZONE, batch_size=BATCH, solver=solver,
              inner_steps=3, seed=0, **DP)
    if fleet:
        kw.update(n_walkers=2, sync_every=2)
    r_cls, cls = (RFleet, FleetRWSADMMTrainer) if fleet else \
        (RTrainer, RWSADMMTrainer)
    ref = r_cls(RS.make_mlr(SHAPE), feds[0], RHP(**HP), **kw)
    port = cls(get_model("mlr", SHAPE), feds[1], RWSADMMHparams(**HP),
               device="cpu", **kw)
    r_state = ref.init_state(jax.random.PRNGKey(0))
    r_base = r_state.base if fleet else r_state
    state = port.init_state(params=_flat(r_base.server.y))
    r_rng, rng = np.random.default_rng(0), np.random.default_rng(0)
    for r in range(3):
        r_state, r_m = ref.round(r_state, r, r_rng)
        state, m = port.round(state, r, rng)
        assert (m["client"], m["zone"]) == (r_m["client"], r_m["zone"])
    r_base = r_state.base if fleet else r_state
    base = state.base if fleet else state
    for got, want in ((base.clients.x, r_base.clients.x),
                      (base.clients.z, r_base.clients.z)):
        np.testing.assert_allclose(got.numpy(), convert._flat_rows(
            jax.tree_util.tree_map(np.asarray, want), 1).numpy(), **TOL)
    np.testing.assert_allclose(base.server.y.numpy(),
                               _flat(r_base.server.y).numpy(), **TOL)
    if fleet:
        np.testing.assert_allclose(state.tokens.numpy(), convert._flat_rows(
            jax.tree_util.tree_map(np.asarray, r_state.tokens),
            1).numpy(), **TOL)
    # The noise moved the token: a run without DP ends elsewhere.
    plain = cls(get_model("mlr", SHAPE), feds[1], RWSADMMHparams(**HP),
                device="cpu", **{k: v for k, v in kw.items()
                                 if k not in DP})
    s = plain.init_state(params=_flat((ref.init_state(
        jax.random.PRNGKey(0)).base if fleet else ref.init_state(
        jax.random.PRNGKey(0))).server.y))
    rng = np.random.default_rng(0)
    for r in range(3):
        s, _ = plain.round(s, r, rng)
    assert not torch.allclose((s.base if fleet else s).server.y,
                              base.server.y, atol=1e-4)


def test_dp_scan_equals_eager_and_lazy_equals_dense(feds):
    """DP on the scan engine equals eager bit for bit (same key tree), and
    on the lazy plane equals the dense plane bit for bit."""
    fac = factory_from_federated(_fed("port"))
    kw = dict(zone_size=ZONE, batch_size=BATCH, solver="closed_form",
              seed=0, device="cpu", **DP)
    runs = []
    for data, engine, extra in ((feds[1], "eager", {}),
                                (feds[1], "scan", {}),
                                (fac, "scan", {"store_capacity": 7})):
        tr = RWSADMMTrainer(get_model("mlr", SHAPE), data,
                            RWSADMMHparams(**HP), **kw, **extra)
        res = run_simulation(tr, rounds=6, eval_every=2, seed=0,
                             engine=engine)
        runs.append(res.round_metrics)
    assert runs[0] == runs[1] == runs[2]


def test_dp_refusals(feds):
    tr = RWSADMMTrainer(get_model("mlr", SHAPE), feds[1],
                        RWSADMMHparams(**HP), solver="closed_form",
                        device="cpu", **DP)
    with pytest.raises(ValueError, match="scan_fused does not support DP"):
        run_simulation(tr, rounds=2, eval_every=2, engine="scan_fused")
    with pytest.raises(ValueError, match="does not support DP"):
        FleetRWSADMMTrainer(get_model("mlr", SHAPE), feds[1],
                            RWSADMMHparams(**HP), solver="closed_form",
                            fleet_mode="simultaneous", device="cpu", **DP)
