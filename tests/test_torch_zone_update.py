"""The port's Eq. 31 zone update against the JAX package's.

The JAX side is ``repro``'s ``rwsadmm_zone_fused_update`` (the Pallas
kernel, in interpret mode on the CPU) and its jnp oracle; the port side is
the plain PyTorch version behind ``zone_fused_update`` on CPU tensors.
Inputs come from numpy with a fixed seed. fp32 at atol = rtol = 1e-6, the
reference's own kernel tolerance (``tests/test_kernels.py``); padded
slots pass x and z through bit-exact.
"""
import numpy as np
import pytest
import torch

from repro.kernels.rwsadmm_update.ops import rwsadmm_zone_fused_update
from repro.kernels.rwsadmm_update.ref import rwsadmm_zone_fused_update_ref
from repro_torch.kernels.rwsadmm_update import ops
from repro_torch.kernels.rwsadmm_update.ref import zone_fused_update_ref
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")
HP = dict(beta=2.0, eps_half=5e-4, n_total=8.0)


def _inputs(zone, n, seed, *, x_equals_y=False):
    rng = np.random.default_rng(seed)
    x, z, g = (rng.standard_normal((zone, n)).astype(np.float32)
               for _ in range(3))
    y = rng.standard_normal(n).astype(np.float32)
    z *= 0.1
    if x_equals_y:          # warm-init first visit: sgn(y − x) = 0
        x[0] = y
    mask = np.ones(zone, np.float32)
    if zone > 1:            # padded tail slots
        mask[-(zone // 2):] = 0.0
    kappa = np.float32(0.01)
    return x, z, y, g, mask, kappa


def _port(x, z, y, g, mask, kappa):
    t = [torch.from_numpy(a) for a in (x, z, y, g, mask)]
    out = ops.zone_fused_update(*t, torch.tensor([kappa]), **HP)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("zone", [1, 3, 8])
@pytest.mark.parametrize("n", [128, 2048, 2048 + 17, 100_003])
def test_zone_update_matches_pallas_kernel(n, zone):
    x, z, y, g, mask, kappa = _inputs(zone, n, seed=n + zone,
                                      x_equals_y=True)
    xk, zk, yk = rwsadmm_zone_fused_update(x, z, y, g, mask, kappa, **HP)
    xr, zr, yr = rwsadmm_zone_fused_update_ref(x, z, y, g, mask, kappa, **HP)
    xp, zp, yp = _port(x, z, y, g, mask, kappa)
    for port, kern, ref in ((xp, xk, xr), (zp, zk, zr), (yp, yk, yr)):
        np.testing.assert_allclose(port, np.asarray(kern), **TOL)
        np.testing.assert_allclose(port, np.asarray(ref), **TOL)
    pad = mask == 0
    assert np.array_equal(xp[pad], x[pad])
    assert np.array_equal(zp[pad], z[pad])


def test_sign_of_zero_is_zero():
    """x = y (warm init): s' = 0, so x⁺ = y − g/β exactly and c = x."""
    x, z, y, g, mask, kappa = _inputs(1, 64, seed=3, x_equals_y=True)
    xp, zp, yp = _port(x, z, y, g, mask, kappa)
    want = (torch.from_numpy(y) - torch.from_numpy(g[0])
            / torch.tensor(HP["beta"])).numpy()
    assert np.array_equal(xp[0], want)


def test_all_padded_zone_leaves_state():
    x, z, y, g, mask, kappa = _inputs(3, 300, seed=5)
    mask[:] = 0.0
    xp, zp, yp = _port(x, z, y, g, mask, kappa)
    assert np.array_equal(xp, x) and np.array_equal(zp, z)
    assert np.array_equal(yp, y)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    x, z, y, g, mask, kappa = _inputs(3, 257, seed=9)
    before = ops.zone_fused_update.launches
    got = _port(x, z, y, g, mask, kappa)
    t = [torch.from_numpy(a) for a in (x, z, y, g, mask)]
    want = zone_fused_update_ref(*t, torch.tensor(kappa), **HP)
    for a, b in zip(got, want):
        assert np.array_equal(a, b.numpy())
    assert ops.zone_fused_update.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous"])
def test_wrapper_rejects_bad_inputs(bad):
    x, z, y, g, mask, kappa = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                               else torch.tensor([a])
                               for a in _inputs(3, 64, seed=1))
    if bad == "dtype":
        x = x.double()
    elif bad == "shape":
        y = y[:-1]
    else:
        x = x.t().contiguous().t()
    with pytest.raises((TypeError, ValueError)):
        ops.zone_fused_update(x, z, y, g, mask, kappa, **HP)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    """On the card: the CUDA kernel against the plain version on the same
    device. x⁺ and z⁺ at 1e-6; y⁺ at 1e-6 too when no sign flips
    (both round after every operation, in the same order)."""
    for zone, n in ((8, 1_068_266), (3, 100_003)):
        x, z, y, g, mask, kappa = _inputs(zone, n, seed=zone)
        t = [torch.from_numpy(a).to(cuda_device) for a in (x, z, y, g, mask)]
        k = torch.tensor([kappa], device=cuda_device)
        before = ops.zone_fused_update.launches
        got = ops.zone_fused_update(*t, k, **HP)
        torch.cuda.synchronize()
        assert ops.zone_fused_update.launches == before + 1
        want = zone_fused_update_ref(*t, k, **HP)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL)
