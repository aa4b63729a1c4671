"""The kernels' shape-only ops (``torch.ops.repro_torch.flash_decode``,
``rglru_scan``, ``rglru_scan_bwd``): on meta tensors each wrapper gives
its output's shape and dtype, the scan's gradient too, and allocates
nothing; on the CPU each wrapper still takes its plain version, bit for
bit, and counts no launch."""
import pytest
import torch

from repro_torch.kernels.flash_decode import ops as fd
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.rglru_scan import ops as rg
from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref, \
    rglru_scan_ref
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("shape", [(2, 5, 8), (1, 524_288, 4096)])
def test_scan_on_meta(shape):
    a = torch.empty(shape, device="meta", requires_grad=True)
    b = torch.empty(shape, device="meta", requires_grad=True)
    h = rg.rglru_scan(a, b)
    assert (h.shape, h.dtype, h.device.type) == (shape, torch.float32,
                                                 "meta")
    da, db = torch.autograd.grad(h.sum(), (a, b))
    assert da.shape == db.shape == shape and da.device.type == "meta"
    da, db = rg.rglru_scan_bwd(a.detach(), h.detach(), h.detach())
    assert da.shape == db.shape == shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_on_meta(dtype):
    q = torch.empty(4, 64, 112, dtype=dtype, device="meta")
    k = torch.empty(4, 32_768, 8, 112, dtype=dtype, device="meta")
    n = torch.empty(4, dtype=torch.int32, device="meta")
    out = fd.flash_decode(q, k, k, n, window=1024)
    assert (out.shape, out.dtype, out.device.type) == (q.shape, dtype,
                                                       "meta")


def test_cpu_paths_unchanged():
    g = torch.Generator().manual_seed(0)
    a, b, dh = (torch.rand(2, 33, 12, generator=g) for _ in range(3))
    launches = (rg.rglru_scan.launches, rg.rglru_scan_bwd.launches,
                fd.flash_decode.launches)
    h = rg.rglru_scan(a, b)
    assert torch.equal(h, rglru_scan_ref(a, b))
    got = rg.rglru_scan_bwd(a, h, dh)
    for x, y in zip(got, rglru_scan_bwd_ref(a, h, dh)):
        assert torch.equal(x, y)
    q = torch.randn(2, 4, 16, generator=g)
    k, v = (torch.randn(2, 9, 2, 16, generator=g) for _ in range(2))
    n = torch.tensor([9, 4], dtype=torch.int32)
    assert torch.equal(fd.flash_decode(q, k, v, n),
                       flash_decode_ref(q, k, v, n))
    assert (rg.rglru_scan.launches, rg.rglru_scan_bwd.launches,
            fd.flash_decode.launches) == launches
