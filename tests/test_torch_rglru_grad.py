"""The gradient of the port's RG-LRU scan against the JAX package's.

The reference has no backward kernel: its gradient is XLA's transpose of
``linear_scan`` (``repro.models.recurrent``, an associative scan), which
``jax.vjp`` gives here, and of its oracle
``repro.kernels.rglru_scan.ref.rglru_scan_ref``. The port's side is
``rglru_scan_bwd_ref`` (the backward kernel's plain loop) and the
gradient of ``rglru_scan`` on CPU tensors (its ``autograd.Function``).
Inputs come from numpy with a fixed seed. Scan gradients agree at atol
1e-5 / rtol 1e-4, the reference's own scan tolerance
(``tests/test_kernels.py``): the associative scan multiplies in another
order. ``rglru_block``'s parameter gradients agree with ``jax.grad`` of
the reference's block at atol 1e-5 / rtol 1e-4 as well (fp32 matmuls
summed in another order; the largest gradients are ~1e-1).

One RWSADMM step of ``make_train_step`` on ``recurrentgemma-9b``'s
``reduced()`` config cut to one ``(rglru, rglru, local)`` group, fp32,
from the reference's weights: loss, x, z, y and κ at
``test_torch_train_step``'s ``STEP_TOL`` (atol 1e-6 / rtol 1e-5) with
its sign-flip rule for y. No wider tolerance is needed: the reference's
own gap between its associative scan and a sequential ``lax.scan`` on
this step is of the same kind (one tie flip of y, x and z within
``STEP_TOL``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.configs import get_config as ref_config
from repro.core.rwsadmm import RWSADMMHparams as RHP
from repro.kernels.rglru_scan.ref import rglru_scan_ref as oracle_scan
from repro.launch import steps as ref_steps
from repro.models import recurrent as R
from repro.models.registry import build_model as ref_build
from repro.models.registry import random_batch as ref_batch
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.kernels.rglru_scan import ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref, \
    rglru_scan_ref
from repro_torch.launch import steps
from repro_torch.models import recurrent as T
from repro_torch.models.registry import build_model
from test_torch_train_step import MAX_FLIP_SHARE, STEP_TOL, _flips, \
    _hold_state
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)
ARCH = "recurrentgemma-9b"
CUT = dict(layer_pattern=("rglru", "rglru", "local"), n_layers=3)
HP = dict(beta=2.0, kappa=0.05, epsilon=1e-3)
N_TOTAL = 8
# 96 tokens: past the reduced window of 64, so the local layer masks
BATCH, SEQ = 2, 96

SHAPES = [(2, 64, 128), (2, 300, 130), (1, 1, 7), (1, 33, 5), (3, 1, 4),
          (2, 129, 100)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(
        np.float32)
    b, dh = (rng.standard_normal(shape).astype(np.float32)
             for _ in range(2))
    return a, b, dh


def _jax_vjp(scan, a, b, dh):
    @jax.jit
    def vjp(a, b, dh):
        return jax.vjp(scan, a, b)[1](dh)
    return tuple(np.asarray(g) for g in vjp(a, b, dh))


def _function_grads(a, b, dh):
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    ops.rglru_scan(ta, tb).backward(torch.from_numpy(dh))
    return ta.grad.numpy(), tb.grad.numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_reference_vjp(shape):
    """The plain backward and the Function's gradient against ``jax.vjp``
    of the reference's associative scan and of its oracle; S = 1, D odd
    and B = 1 among the shapes."""
    a, b, dh = _inputs(shape, seed=sum(shape))
    h = rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    plain = tuple(g.numpy() for g in rglru_scan_bwd_ref(
        torch.from_numpy(a), h, torch.from_numpy(dh)))
    function = _function_grads(a, b, dh)
    for scan in (R.linear_scan, oracle_scan):
        want = _jax_vjp(scan, a, b, dh)
        for got in (plain, function):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, **TOL)
    for g, p in zip(function, plain):       # the Function is the plain loop
        np.testing.assert_array_equal(g, p)
    assert not plain[0][:, 0].any()          # da_0 = g_0 · h_{−1} = 0


def test_backward_is_the_adjoint_recurrence():
    """Written out: db_t = Σ_{u ≥ t} dh_u Π_{t < v ≤ u} a_v, da_t =
    db_t h_{t−1}, in float64 on a short sequence."""
    a, b, dh = (x.astype(np.float64) for x in _inputs((2, 6, 3), seed=4))
    h = np.zeros_like(a)
    carry = np.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        carry = a[:, t] * carry + b[:, t]
        h[:, t] = carry
    db = np.zeros_like(a)
    for t in range(a.shape[1]):
        for u in range(t, a.shape[1]):
            db[:, t] += dh[:, u] * np.prod(a[:, t + 1:u + 1], axis=1)
    da = db * np.concatenate([np.zeros_like(h[:, :1]), h[:, :-1]], axis=1)
    got = rglru_scan_bwd_ref(*(torch.from_numpy(x) for x in (a, h, dh)))
    np.testing.assert_allclose(got[0].numpy(), da, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), db, rtol=1e-12, atol=1e-12)


def test_function_under_checkpoint():
    """Under the non-reentrant checkpoint that ``transformer._remat``
    uses, the recompute saves its own a and h and the gradients equal the
    plain run's bit for bit; a non-contiguous dh is made contiguous."""
    a, b, dh = _inputs((2, 40, 9), seed=11)
    want = _function_grads(a, b, dh)
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    weight = torch.from_numpy(dh)
    out = checkpoint(lambda x, y: ops.rglru_scan(x * 1.0, y) * weight, ta,
                     tb, use_reentrant=False)
    out.sum().backward()
    np.testing.assert_array_equal(ta.grad.numpy(), want[0])
    np.testing.assert_array_equal(tb.grad.numpy(), want[1])
    ta.grad = tb.grad = None
    # dh arrives transposed-strided: the Function makes it contiguous
    h = ops.rglru_scan(ta, tb)
    h.backward(torch.from_numpy(np.ascontiguousarray(
        dh.transpose(0, 2, 1))).transpose(1, 2))
    np.testing.assert_array_equal(ta.grad.numpy(), want[0])


def test_backward_rejects_what_the_kernel_does_not_take():
    a = torch.rand(2, 5, 4)
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_scan_bwd(a, a, a.double())
    with pytest.raises(ValueError, match="shape"):
        ops.rglru_scan_bwd(a, a, a[:, :4].contiguous())
    sq = torch.rand(2, 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan_bwd(sq, sq, sq.transpose(1, 2))
    with pytest.raises(ValueError, match=r"\(B, S, D\)"):
        ops.rglru_scan_bwd(a[0], a[0], a[0])


def test_no_grad_keeps_the_forward_alone():
    """Under ``torch.no_grad`` the scan is its forward: no graph."""
    a, b, _ = _inputs((1, 8, 4), seed=2)
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    with torch.no_grad():
        h = ops.rglru_scan(ta, tb)
    assert h.grad_fn is None and not h.requires_grad


# ------------------------------------------------------------- block --
def _block_pair(seed=0):
    rcfg = ref_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    params = jax.tree_util.tree_map(
        np.asarray, R.rglru_init(jax.random.PRNGKey(seed), rcfg))
    mod = T.RGLRU(cfg)
    convert.load_reference(mod, params)
    return params, mod, cfg


@pytest.mark.parametrize("s", [1, 24, 130])
def test_rglru_block_grads_match_reference(s):
    """Gradients of Σ w ⊙ block(x) in every parameter and in x against
    ``jax.grad`` of the reference's block (its associative scan)."""
    params, mod, cfg = _block_pair(seed=s)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)

    def ref_loss(p, x):
        return jnp.sum(R.rglru_block(p, x) * w)
    want_p, want_x = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    (T.rglru_block(mod, tx) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), **TOL)
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_p[name]),
                                   err_msg=name, **TOL)


# -------------------------------------------------------------- step --
def test_hybrid_train_step_matches_reference():
    """One fp32 RWSADMM step of the (rglru, rglru, local) cut from the
    reference's weights and state: the loss, x, z and y leaf by leaf
    (y's sign flips at ties left out) and κ; then the step again with the
    result as its state, as the walk chains them."""
    rcfg = dataclasses.replace(ref_config(ARCH).reduced(), **CUT)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **CUT)
    ref = ref_build(rcfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = build_model(cfg, device="cpu")
    state = convert.lm_state_from_reference(
        jax.tree_util.tree_map(np.asarray, params), cfg)
    assert [b.kind for b in port.layers] == list(CUT["layer_pattern"])
    r_step = jax.jit(ref_steps.make_train_step(ref, RHP(**HP), N_TOTAL))
    step = steps.make_train_step(port, RWSADMMHparams(**HP), N_TOTAL)
    r_st = ref_steps.init_train_state(params, RHP(**HP))
    st = steps.init_train_state(state, RWSADMMHparams(**HP))
    for seed in (10, 11):
        batch = ref_batch(rcfg, BATCH, SEQ, seed=seed)
        before = ops.rglru_scan.launches
        r_next, r_loss = r_step(r_st, batch)
        st, loss = step(st, {"tokens": torch.as_tensor(
            np.array(batch["tokens"]))})
        assert ops.rglru_scan.launches == before   # the CPU runs no kernel
        np.testing.assert_allclose(float(loss), float(r_loss), **STEP_TOL)
        skip = {}
        for leaf, (flip, gap) in _flips(cfg, r_st, r_next, st).items():
            assert bool((gap[flip] <= 1).all()), (leaf, gap[flip])
            assert int(flip.sum()) <= MAX_FLIP_SHARE * flip.numel() + 1
            skip[leaf] = flip
        _hold_state(cfg, r_next, st, STEP_TOL, skip)
        moved = [k for k in st.x if not torch.equal(st.x[k], state[k])]
        assert any("mix.lam" in k for k in moved)   # the scan's gradient
        r_st = r_next
        # the next step from the reference's state, as the fp32 steps of
        # test_torch_train_step are held
        st = steps.TrainState(*(convert.lm_state_from_reference(
            jax.tree_util.tree_map(np.asarray, getattr(r_st, n)), cfg)
            for n in ("x", "z", "y")), kappa=torch.tensor(float(r_st.kappa)))


# -------------------------------------------------------------- card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def test_backward_counts_launches_by_path():
    """The backward counts its launches by path as the forward does; a
    CPU tensor takes the plain loop and counts none."""
    assert set(ops.rglru_scan_bwd.launches_by_path) == set(ops.PATHS)
    a, b, dh = (torch.from_numpy(x) for x in _inputs((1, 5, 8), seed=2))
    before = dict(ops.rglru_scan_bwd.launches_by_path)
    ops.rglru_scan_bwd(a, rglru_scan_ref(a, b), dh)
    assert ops.rglru_scan_bwd.launches_by_path == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape,path", [
    ((2, 2048, 4096), "staged"), ((4, 2040, 4096), "staged"),
    ((2, 77, 4096), "staged"), ((1, 1, 4096), "staged"),
    ((3, 129, 100), "staged"), ((2, 77, 100), "staged"),
    ((1, 2048, 100), "staged"), ((1, 1, 36), "staged"),
    ((1, 77, 36), "staged"), ((2, 65, 4), "staged"),
    ((2, 1000, 130), "loop"), ((1, 77, 130), "loop"),
    ((1, 3, 7), "loop"), ((1, 1, 7), "loop"), ((1, 2048, 7), "loop")])
def test_backward_kernel_matches_plain_version_on_card(cuda_device, shape,
                                                       path):
    """Bit for bit on both paths: the same multiply, then add, in the same
    order. S of 1, 77 (the staged ring's short last stage) and 2048, D
    not a multiple of 4 or 32, B = 1; one launch a call on the planned
    path; and the Function's gradient is the kernel's."""
    a, b, dh = (torch.from_numpy(x).to(cuda_device)
                for x in _inputs(shape, seed=sum(shape)))
    h = ops.rglru_scan(a, b)
    before = ops.rglru_scan_bwd.launches
    by_path = dict(ops.rglru_scan_bwd.launches_by_path)
    da, db = ops.rglru_scan_bwd(a, h, dh)
    torch.cuda.synchronize()
    assert ops.rglru_scan_bwd.launches == before + 1
    assert ops.rglru_scan_bwd.launches_by_path[path] == by_path[path] + 1
    want = rglru_scan_bwd_ref(a, h, dh)
    assert torch.equal(da, want[0]) and torch.equal(db, want[1])
    ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
    ops.rglru_scan(ta, tb).backward(dh)
    assert torch.equal(ta.grad, da) and torch.equal(tb.grad, db)


@pytest.mark.cuda
def test_backward_kernel_runs_on_a_new_thread(cuda_device):
    """The staged backward encodes its tensor maps on the calling thread,
    which needs a current context: a thread that has made no CUDA call
    yet (as autograd's may be) launches it all the same."""
    import threading

    shape = (2, 77, 64)
    a, b, dh = (torch.from_numpy(x).to(cuda_device)
                for x in _inputs(shape, seed=9))
    h = ops.rglru_scan(a, b)
    out = []
    worker = threading.Thread(
        target=lambda: out.append(ops.rglru_scan_bwd(a, h, dh)))
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    assert len(out) == 1
    want = rglru_scan_bwd_ref(a, h, dh)
    assert torch.equal(out[0][0], want[0]) and torch.equal(out[0][1],
                                                           want[1])


@pytest.mark.cuda
def test_unaligned_backward_takes_the_loop_on_card(cuda_device):
    """A view one float past an aligned start cannot feed bulk copies: the
    backward takes the loop there, bit for bit all the same."""
    shape = (2, 100, 64)
    a, b, dh = (torch.from_numpy(x).to(cuda_device)
                for x in _inputs(shape, seed=5))
    h = ops.rglru_scan(a, b)
    a1 = torch.empty(a.numel() + 1, device=cuda_device)[1:].view(shape)
    a1.copy_(a)
    before = dict(ops.rglru_scan_bwd.launches_by_path)
    da, db = ops.rglru_scan_bwd(a1, h, dh)
    torch.cuda.synchronize()
    assert ops.rglru_scan_bwd.launches_by_path == before | {
        "loop": before["loop"] + 1}
    want = rglru_scan_bwd_ref(a, h, dh)
    assert torch.equal(da, want[0]) and torch.equal(db, want[1])
