"""The port's multi-zone (fleet) and single-client Eq. 31 updates against
the JAX package's.

The JAX side is ``repro``'s ``rwsadmm_multizone_fused_update`` and
``rwsadmm_fused_update`` (the Pallas kernels, in interpret mode on the
CPU) and their jnp oracles; the port side is the plain PyTorch version
behind ``multizone_fused_update`` / ``fused_update`` on CPU tensors.
Inputs come from numpy with a fixed seed. fp32 at atol = rtol = 1e-6, the
reference's own kernel tolerance (``tests/test_kernels.py``); padded
slots and idle walkers pass through bit-exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rwsadmm as R
from repro.kernels.rwsadmm_update.ops import rwsadmm_fused_update, \
    rwsadmm_multizone_fused_update
from repro.kernels.rwsadmm_update.ref import rwsadmm_fused_update_ref
from repro_torch.core import rwsadmm as P
from repro_torch.kernels.rwsadmm_update import ops
from repro_torch.kernels.rwsadmm_update.ref import fused_update_ref, \
    multizone_fused_update_ref, zone_fused_update_ref
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-6, rtol=1e-6)
HP = dict(beta=2.0, eps_half=5e-4, n_total=8.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _multizone_inputs(walkers, zone, n, seed, *, idle=None):
    """x/z/g (K, Z, N), y (K, N): slot 0 of walker 0 has x = y (sgn(0));
    each walker pads a different tail; walker ``idle`` is all padding."""
    rng = np.random.default_rng(seed)
    x, z, g = (rng.standard_normal((walkers, zone, n)).astype(np.float32)
               for _ in range(3))
    y = rng.standard_normal((walkers, n)).astype(np.float32)
    z *= 0.1
    x[0, 0] = y[0]
    mask = np.ones((walkers, zone), np.float32)
    for k in range(walkers):
        mask[k, zone - k % zone:] = 0.0     # walker k pads k % Z slots
    if idle is not None:
        mask[idle] = 0.0
    return x, z, y, g, mask, np.float32(0.01)


def _port_multizone(x, z, y, g, mask, kappa):
    t = [torch.from_numpy(a) for a in (x, z, y, g, mask)]
    out = ops.multizone_fused_update(*t, torch.tensor([kappa]), **HP)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("walkers", [1, 3])
@pytest.mark.parametrize("zone", [1, 3, 8])
@pytest.mark.parametrize("n", [128, 2048 + 17])
def test_multizone_matches_pallas_kernel(walkers, zone, n):
    x, z, y, g, mask, kappa = _multizone_inputs(walkers, zone, n,
                                                seed=n + 10 * zone + walkers)
    xk, zk, yk = rwsadmm_multizone_fused_update(x, z, y, g, mask, kappa,
                                                **HP)
    oracle, yo = R.multizone_round_masked(
        R.ClientState(x=jnp.asarray(x), z=jnp.asarray(z)), jnp.asarray(y),
        jnp.asarray(g), jnp.asarray(mask), R.RWSADMMHparams(
            beta=HP["beta"], epsilon=2 * HP["eps_half"]),
        jnp.float32(kappa), HP["n_total"])
    xp, zp, yp = _port_multizone(x, z, y, g, mask, kappa)
    for port, kern, ref in ((xp, xk, oracle.x), (zp, zk, oracle.z),
                            (yp, yk, yo)):
        np.testing.assert_allclose(port, np.asarray(kern), **TOL)
        np.testing.assert_allclose(port, np.asarray(ref), **TOL)
    pad = mask == 0
    assert np.array_equal(xp[pad], x[pad]) and np.array_equal(zp[pad], z[pad])


def test_idle_walker_passes_through_bit_exact():
    """A walker whose zone is all padding (every client claimed by an
    earlier walker) leaves its rows and its token unchanged."""
    x, z, y, g, mask, kappa = _multizone_inputs(3, 4, 517, seed=7, idle=1)
    xp, zp, yp = _port_multizone(x, z, y, g, mask, kappa)
    assert np.array_equal(xp[1], x[1]) and np.array_equal(zp[1], z[1])
    assert np.array_equal(yp[1], y[1])
    assert not np.array_equal(yp[0], y[0])


def test_multizone_rows_equal_zone_update_per_walker():
    """Walker k of the multi-zone update is exactly the single-zone
    update of its own rows against its own token."""
    x, z, y, g, mask, kappa = _multizone_inputs(3, 5, 300, seed=11)
    xp, zp, yp = _port_multizone(x, z, y, g, mask, kappa)
    for k in range(3):
        t = [torch.from_numpy(a[k]) for a in (x, z, y, g, mask)]
        xs, zs, ys = zone_fused_update_ref(*t, torch.tensor(kappa), **HP)
        assert np.array_equal(xs.numpy(), xp[k])
        assert np.array_equal(zs.numpy(), zp[k])
        assert np.array_equal(ys.numpy(), yp[k])


def test_core_multizone_oracle_matches_fused_ref():
    """``core.rwsadmm.multizone_round_masked`` (the trainer's plain path)
    against the kernel's plain version."""
    x, z, y, g, mask, kappa = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                               else torch.tensor(a)
                               for a in _multizone_inputs(3, 4, 257, seed=3))
    hp = P.RWSADMMHparams(beta=HP["beta"], epsilon=2 * HP["eps_half"])
    new, yo = P.multizone_round_masked(P.ClientState(x=x, z=z), y, g, mask,
                                       hp, kappa, HP["n_total"])
    xr, zr, yr = multizone_fused_update_ref(x, z, y, g, mask, kappa, **HP)
    for a, b in ((new.x, xr), (new.z, zr), (yo, yr)):
        torch.testing.assert_close(a, b, **TOL)


def _fused_inputs(n, seed):
    rng = np.random.default_rng(seed)
    x, z, y, g = (rng.standard_normal(n).astype(np.float32)
                  for _ in range(4))
    z *= 0.1
    x[: n // 4] = y[: n // 4]          # warm-init part: sgn(y − x) = 0
    return x, z, y, g


@pytest.mark.parametrize("n", [128, 8192 + 17, 100_003])
def test_fused_update_matches_pallas_kernel(n):
    x, z, y, g = _fused_inputs(n, seed=n)
    kappa = np.float32(0.01)
    xk, zk, yk = rwsadmm_fused_update({"w": x}, {"w": z}, {"w": y},
                                      {"w": g}, kappa, **HP)
    xr, zr, yr = rwsadmm_fused_update_ref(x, z, y, g, kappa, **HP)
    out = ops.fused_update(*(torch.from_numpy(a) for a in (x, z, y, g)),
                           torch.tensor(kappa), **HP)
    for port, kern, ref in zip((o.numpy() for o in out),
                               (xk["w"], zk["w"], yk["w"]), (xr, zr, yr)):
        np.testing.assert_allclose(port, np.asarray(kern), **TOL)
        np.testing.assert_allclose(port, np.asarray(ref), **TOL)


@pytest.mark.parametrize("seed", range(6))
def test_fused_update_fixed_point(seed):
    """g = z = ε = 0 keeps x = y (``tests/test_kernels.py``'s property)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5000))
    beta = float(rng.uniform(0.5, 100.0))
    kappa = torch.tensor(float(rng.uniform(0.0, 1.0)))
    y = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    zeros = torch.zeros(n)
    xp, zp, yp = ops.fused_update(y.clone(), zeros, y, zeros, kappa,
                                  beta=beta, eps_half=0.0, n_total=5.0)
    torch.testing.assert_close(xp, y, **TOL)
    torch.testing.assert_close(yp, y, **TOL)


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    before = (ops.multizone_fused_update.launches, ops.fused_update.launches,
              ops.zone_fused_update.launches)
    x, z, y, g, mask, kappa = _multizone_inputs(2, 3, 99, seed=2)
    got = _port_multizone(x, z, y, g, mask, kappa)
    t = [torch.from_numpy(a) for a in (x, z, y, g, mask)]
    want = multizone_fused_update_ref(*t, torch.tensor(kappa), **HP)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(got, want))
    f = [torch.from_numpy(a) for a in _fused_inputs(99, seed=2)]
    got = ops.fused_update(*f, torch.tensor(kappa), **HP)
    want = fused_update_ref(*f, torch.tensor(kappa), **HP)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (ops.multizone_fused_update.launches, ops.fused_update.launches,
            ops.zone_fused_update.launches) == before


def _bad(args: list, bad: str, target: int, shrink: int):
    if bad == "dtype":
        args[target] = args[target].double()
    elif bad == "shape":
        args[shrink] = args[shrink][..., :-1].contiguous()
    else:
        t = args[target]
        args[target] = t.transpose(-1, -2).contiguous().transpose(-1, -2) \
            if t.dim() > 1 else t.repeat(2)[::2]
    return args


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous"])
def test_multizone_wrapper_rejects_bad_inputs(bad):
    x, z, y, g, mask, kappa = _multizone_inputs(2, 3, 64, seed=1)
    args = [torch.from_numpy(a) for a in (x, z, y, g, mask)]
    args = _bad(args, bad, target=0, shrink=2)
    with pytest.raises((TypeError, ValueError)):
        ops.multizone_fused_update(*args, torch.tensor([kappa]), **HP)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous"])
def test_fused_wrapper_rejects_bad_inputs(bad):
    args = [torch.from_numpy(a) for a in _fused_inputs(64, seed=1)]
    args = _bad(args, bad, target=3, shrink=2)
    with pytest.raises((TypeError, ValueError)):
        ops.fused_update(*args, torch.tensor([0.01]), **HP)


@pytest.mark.cuda
def test_cuda_multizone_and_fused_kernels_match_plain_versions(cuda_device):
    """On the card: each kernel against its plain version on the same
    device, bit for bit (same operations in the same order, -fmad=false),
    idle walker and padded slots included."""
    k = torch.tensor([0.01], device=cuda_device)
    for walkers, zone, n, idle in ((3, 8, 1_068_266, 2), (2, 3, 100_003,
                                                          None)):
        t = [torch.from_numpy(a).to(cuda_device) for a in
             _multizone_inputs(walkers, zone, n, seed=zone, idle=idle)[:5]]
        before = ops.multizone_fused_update.launches
        got = ops.multizone_fused_update(*t, k, **HP)
        torch.cuda.synchronize()
        assert ops.multizone_fused_update.launches == before + 1
        want = multizone_fused_update_ref(*t, k, **HP)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for n in (1_068_266, 100_003):
        f = [torch.from_numpy(a).to(cuda_device)
             for a in _fused_inputs(n, seed=n)]
        before = ops.fused_update.launches
        got = ops.fused_update(*f, k, **HP)
        torch.cuda.synchronize()
        assert ops.fused_update.launches == before + 1
        want = fused_update_ref(*f, k, **HP)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
