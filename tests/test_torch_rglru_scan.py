"""The port's RG-LRU scan and recurrent block against the JAX package's.

The JAX side is ``repro``'s ``rglru_scan`` (the Pallas kernel, in
interpret mode on the CPU), its oracle ``rglru_scan_ref`` (the
associative scan) and ``models.recurrent``; the port side is the plain
sequential loop behind ``ops.rglru_scan`` on CPU tensors. Inputs come from
numpy with a fixed seed. The scan agrees at atol 1e-5 / rtol 1e-4, the
reference's own tolerance (``tests/test_kernels.py``): the associative
scan multiplies in another order. The block and its decode step agree at
atol 1e-5 / rtol 1e-4 too (same fp32 math, matmuls summed in another
order).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels.rglru_scan.ops import rglru_scan as pallas_scan
from repro.kernels.rglru_scan.ref import rglru_scan_ref as oracle_scan
from repro.models import recurrent as R
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.rglru_scan import ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.models import recurrent as T
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _ab(bsz, s, d, seed):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((bsz, s, d))))).astype(
        np.float32)
    b = rng.standard_normal((bsz, s, d)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("s,d", [(64, 128), (300, 130), (1024, 256),
                                 (513, 64)])
def test_scan_matches_pallas_kernel_and_oracle(s, d):
    a, b = _ab(2, s, d, seed=s * d)
    got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas_scan(a, b)), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle_scan(a, b)), **TOL)


def test_scan_properties():
    """a = 0 ⇒ h = b; a = 1, b = 0 ⇒ h = 0; the wrapper on a CPU tensor is
    its plain version."""
    a, b = _ab(3, 77, 40, seed=5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(ops.rglru_scan(torch.zeros_like(ta), tb), tb)
    zero = ops.rglru_scan(torch.ones_like(ta), torch.zeros_like(tb))
    assert torch.equal(zero, torch.zeros_like(tb))
    assert torch.equal(ops.rglru_scan(ta, tb), rglru_scan_ref(ta, tb))


def test_scan_rejects_what_the_kernel_does_not_take():
    a = torch.rand(2, 5, 4)
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_scan(a.double(), a.double())
    with pytest.raises(ValueError, match="shape"):
        ops.rglru_scan(a, a[:, :4])
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match=r"\(B, S, D\)"):
        ops.rglru_scan(a[0], a[0])


def _block_pair(seed=0):
    rcfg = ref_config("recurrentgemma-9b").reduced()
    cfg = get_config("recurrentgemma-9b").reduced()
    params = jax.tree_util.tree_map(
        np.asarray, R.rglru_init(jax.random.PRNGKey(seed), rcfg))
    mod = T.RGLRU(cfg)
    convert.load_reference(mod, params)
    return params, mod, cfg


@pytest.mark.parametrize("use_pallas", [False, True])
def test_rglru_block_matches_reference(use_pallas):
    params, mod, cfg = _block_pair()
    x = np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    want = R.rglru_block(params, x, use_pallas=use_pallas)
    with torch.no_grad():
        got = T.rglru_block(mod, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [2, 24])
def test_rglru_state_and_decode_match_reference(s):
    """Prefill state (a prompt shorter than the conv history pads it),
    then 5 decode steps: outputs and states as the reference's."""
    params, mod, cfg = _block_pair(seed=2)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    out_r, st_r = R.rglru_block(params, x, return_state=True)
    with torch.no_grad():
        out_p, st_p = T.rglru_block(mod, torch.from_numpy(x),
                                    return_state=True)
        np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), **TOL)
        for _ in range(5):
            np.testing.assert_allclose(st_p.h.numpy(), np.asarray(st_r.h),
                                       **TOL)
            np.testing.assert_allclose(st_p.conv.numpy(),
                                       np.asarray(st_r.conv), **TOL)
            xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
            out_r, st_r = R.rglru_decode_step(params, xt, st_r)
            out_p, st_p = T.rglru_decode_step(mod, torch.from_numpy(xt),
                                              st_p)
            np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r),
                                       **TOL)


@pytest.mark.parametrize("shape,path", [
    ((4, 2040, 4096), "staged"), ((2, 1000, 130), "loop"),
    ((3, 64, 32), "staged"), ((1, 1, 4), "staged"), ((2, 65, 100), "staged"),
    ((1, 7, 33), "loop")])
def test_scan_plan_fits_shared_memory_and_tails(shape, path):
    """The staged path takes D % 4 == 0 and 16-byte-aligned tensors, as
    its bulk copies need; any other input takes the register loop. The
    ring's shared memory and the S and D tails are the source's, held on
    the card by the shapes of ``test_kernel_matches_plain_version_on_card``
    (S not a multiple of the stage, D not a multiple of 32)."""
    assert ops.plan(shape) == path
    assert ops.plan(shape, aligned=False) == "loop"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,path", [
    ((4, 2040, 4096), "staged"), ((2, 1000, 130), "loop"),
    ((3, 129, 100), "staged"), ((2, 64, 4), "staged"),
    ((1, 3, 36), "staged")])
def test_kernel_matches_plain_version_on_card(cuda_device, shape, path):
    """Bit for bit on both paths: the same multiply, then add, in the same
    order. S not a multiple of the stage, D not a multiple of 32."""
    a, b = (torch.from_numpy(x).to(cuda_device)
            for x in _ab(*shape, seed=sum(shape)))
    before = ops.rglru_scan.launches
    by_path = dict(ops.rglru_scan.launches_by_path)
    got = ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert ops.rglru_scan.launches == before + 1
    assert ops.rglru_scan.launches_by_path[path] == by_path[path] + 1
    assert torch.equal(got, rglru_scan_ref(a, b))


@pytest.mark.cuda
def test_unaligned_tensors_take_the_loop_on_card(cuda_device):
    """A view 4 bytes past an aligned start cannot feed bulk copies."""
    shape = (2, 100, 64)
    a, b = (torch.from_numpy(x).to(cuda_device) for x in _ab(*shape, 3))
    n = a.numel()
    a1 = torch.empty(n + 1, device=cuda_device)[1:].view(shape)
    b1 = torch.empty(n + 1, device=cuda_device)[1:].view(shape)
    a1.copy_(a)
    b1.copy_(b)
    before = ops.rglru_scan.launches_by_path["loop"]
    got = ops.rglru_scan(a1, b1)
    torch.cuda.synchronize()
    assert ops.rglru_scan.launches_by_path["loop"] == before + 1
    assert torch.equal(got, rglru_scan_ref(a, b))
