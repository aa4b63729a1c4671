"""Flash decode has no backward (no training path runs it), so on the
card it refuses to run where autograd would need one (grad mode on and
an input requiring grad) instead of cutting the graph; the RG-LRU scan
has a backward kernel, so on the card it carries the gradient as its
plain version does. On the CPU the plain versions carry the gradient.
The plain scan's gradient (through the scan's ``autograd.Function``) is
held to a recurrence written out here, the plain decode attention's to a
softmax written out here (atol 1e-5 / rtol 1e-4, fp32 sums in other
orders)."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)


def _leaf(rng, shape):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                        requires_grad=True)


def _grads(fn, inputs, weight):
    out = fn(*inputs)
    (out * weight).sum().backward()
    grads = [t.grad.clone() for t in inputs]
    for t in inputs:
        t.grad = None
    return grads


def test_plain_scan_carries_gradients():
    rng = np.random.default_rng(0)
    a, b = _leaf(rng, (2, 9, 5)), _leaf(rng, (2, 9, 5))
    weight = torch.tensor(rng.standard_normal((2, 9, 5)).astype(np.float32))

    def written_out(a, b):
        h, hs = torch.zeros_like(a[:, 0]), []
        for t in range(a.shape[1]):
            h = a[:, t] * h + b[:, t]
            hs.append(h)
        return torch.stack(hs, 1)
    for got, want in zip(_grads(rglru_scan, (a, b), weight),
                         _grads(written_out, (a, b), weight)):
        torch.testing.assert_close(got, want, **TOL)


def test_plain_decode_attention_carries_gradients():
    rng = np.random.default_rng(1)
    b, h, kv, hd, s = 2, 4, 2, 8, 11
    q, k, v = (_leaf(rng, (b, h, hd)), _leaf(rng, (b, s, kv, hd)),
               _leaf(rng, (b, s, kv, hd)))
    length = torch.tensor([11, 6], dtype=torch.int32)
    weight = torch.tensor(rng.standard_normal((b, h, hd)).astype(np.float32))

    def written_out(q, k, v):
        g = h // kv
        kk = k.repeat_interleave(g, dim=2)              # (B, S, H, hd)
        vv = v.repeat_interleave(g, dim=2)
        scores = torch.einsum("bhd,bshd->bhs", q, kk) / math.sqrt(hd)
        valid = torch.arange(s)[None, :] < length[:, None]
        scores = scores.masked_fill(~valid[:, None, :], float("-inf"))
        return torch.einsum("bhs,bshd->bhd", scores.softmax(-1), vv)
    for got, want in zip(
            _grads(lambda *t: flash_decode(*t, length), (q, k, v), weight),
            _grads(written_out, (q, k, v), weight)):
        torch.testing.assert_close(got, want, **TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_refuse_grad_on_card(cuda_device):
    """Flash decode refuses; the scan carries its gradient through its
    backward kernel, the same as its plain version's on the card."""
    rng = np.random.default_rng(2)
    a = _leaf(rng, (1, 8, 32)).to(cuda_device).detach().requires_grad_()
    b = _leaf(rng, (1, 8, 32)).to(cuda_device).detach().requires_grad_()
    weight = torch.tensor(rng.standard_normal((1, 8, 32)).astype(
        np.float32), device=cuda_device)
    got = _grads(rglru_scan, (a, b), weight)
    assert got[0].abs().max() > 0 and got[1].abs().max() > 0
    for g, want in zip(got, _grads(rglru_scan_ref, (a, b), weight)):
        torch.testing.assert_close(g, want, **TOL)
    with torch.no_grad():
        rglru_scan(a, b)                       # inference is untouched
    q = torch.rand(1, 2, 64, device=cuda_device, requires_grad=True)
    k = torch.rand(1, 16, 1, 64, device=cuda_device)
    length = torch.tensor([16], device=cuda_device, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="flash_decode has no backward"):
        flash_decode(q, k, k, length)
    with torch.no_grad():
        flash_decode(q, k, k, length)
