"""The recurrent blocks of the model zoo (the JAX package's
``models/recurrent.py``): Griffin's RG-LRU (RecurrentGemma) and the
xLSTM's mLSTM and sLSTM.

RG-LRU: h_t = a_t ⊙ h_{t−1} + b_t runs through the RG-LRU scan kernel
(``kernels/rglru_scan``): on a CUDA tensor it launches the kernel, on a
CPU tensor it takes the plain sequential loop; in backward the scan's
own backward kernel (or its plain loop) gives the gradients of a and b. The recurrence and its
gates are fp32; the conv history is kept in the config's dtype.

mLSTM: a matrix memory C (B, H, hd, hd) with hd = 2·d_model / n_heads,
its normaliser n and a log-space stabiliser m, all fp32. A sequence runs
in the parallel (decay-masked linear-attention) form when it is at most
one chunk long and no state is asked for, else in the chunkwise form
that carries (C, n, m) from chunk to chunk; decode updates the state one
token at a time. The port picks the form as the reference does, so both
packages round alike at every length.

sLSTM: a scalar memory with a recurrent gate non-linearity, so it has no
parallel form: a Python loop over time steps (the reference's
``lax.scan``).

Plain torch ops only: the JAX package has no kernel for either xLSTM
block. Dtypes follow the reference's promotion step by step (see
``_qkv``, ``_mlstm_gates`` and ``_slstm_cell``). Maxima that set a
stabiliser use ``torch.amax`` and ``torch.maximum``, whose gradients
split ties as JAX's ``max`` and ``maximum`` do.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import prng
from ..kernels.rglru_scan.ops import rglru_scan
from .layers import batch_split_only, dense_init, normal_init, param, \
    reshape, torch_dtype

_C_RGLRU = 8.0  # Griffin's fixed recurrence sharpness


class RGLRU(nn.Module):
    """Parameters of one RG-LRU block, named as the reference's dict."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d, dt = cfg.d_model, torch_dtype(cfg)
        kw = dict(dtype=dt, device=device)
        self.w_x = param(d, d, **kw)        # recurrence branch in-proj
        self.w_g = param(d, d, **kw)        # gate branch in-proj
        self.conv_w = param(4, d, **kw)     # depthwise causal conv taps
        self.w_rg = param(d, d, **kw)       # recurrence gate r_t
        self.w_ig = param(d, d, **kw)       # input gate i_t
        self.lam = param(d, dtype=torch.float32, device=device)
        self.w_out = param(d, d, **kw)

    def reset_parameters(self, key: torch.Tensor) -> None:
        """The reference's ``rglru_init``: ``split(key, 6)``; the conv taps
        at 0.1 under the third key, Λ 0.7."""
        ks = prng.split(key, 6)
        dense_init(self.w_x, ks[0])
        dense_init(self.w_g, ks[1])
        normal_init(self.conv_w, ks[2], 0.1)
        dense_init(self.w_rg, ks[3])
        dense_init(self.w_ig, ks[4])
        with torch.no_grad():
            self.lam.fill_(0.7)
        dense_init(self.w_out, ks[5])


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, d) fp32 recurrent state
    conv: torch.Tensor       # (B, 3, d) last conv inputs, oldest first


def rglru_init_state(cfg, batch: int, device=None) -> RGLRUState:
    d = cfg.d_model
    return RGLRUState(
        h=torch.zeros(batch, d, dtype=torch.float32, device=device),
        conv=torch.zeros(batch, 3, d, dtype=torch_dtype(cfg), device=device))


def _causal_conv4(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d), w: (4, d): out_t = Σ_k x_{t−k}·w[k], zero before 0."""
    s = x.shape[1]
    w = w.to(x.dtype)
    out = x * w[0]
    for k in range(1, 4):
        shifted = F.pad(x, (0, 0, k, 0))[:, :s]
        out = out + shifted * w[k]
    return out


def _rglru_gates(p, u: torch.Tensor):
    r = torch.sigmoid((u @ p.w_rg).float())
    i = torch.sigmoid((u @ p.w_ig).float())
    log_a = -_C_RGLRU * F.softplus(p.lam) * r               # (B, S, d) fp32
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    b = mult * i * u.float()
    return a, b


def rglru_block(p, x: torch.Tensor, return_state: bool = False):
    """Full Griffin recurrent block: (B, S, d) → (B, S, d), and the state
    after the last token when ``return_state``."""
    u_in = x @ p.w_x
    u = _causal_conv4(u_in, p.conv_w)
    gate = F.gelu((x @ p.w_g).float(), approximate="tanh")
    a, b = _rglru_gates(p, u)
    h = rglru_scan(a.contiguous(), b.contiguous())
    out = (h * gate).to(x.dtype) @ p.w_out
    if not return_state:
        return out
    s = x.shape[1]
    # Copies, so that the state does not keep the whole of h and u_in.
    conv_hist = u_in[:, max(0, s - 3):].clone()
    if s < 3:                       # short prompt: zeros before token 0
        conv_hist = F.pad(conv_hist, (0, 0, 3 - s, 0))
    return out, RGLRUState(h=h[:, -1].clone(), conv=conv_hist)


def rglru_decode_step(p, x: torch.Tensor, state: RGLRUState):
    """x: (B, 1, d), one token; O(1) state update."""
    u_in = (x @ p.w_x)[:, 0]                                  # (B, d)
    hist = torch.cat([state.conv, u_in[:, None]], dim=1)      # (B, 4, d)
    w = p.conv_w.to(u_in.dtype)
    # The history runs oldest first, so the newest input meets tap 0.
    u = torch.einsum("bkd,kd->bd", hist, w.flip(0))
    gate = F.gelu((x @ p.w_g).float(), approximate="tanh")[:, 0]
    a, b = _rglru_gates(p, u[:, None])
    h = a[:, 0] * state.h + b[:, 0]
    out = (h * gate).to(x.dtype)[:, None]
    return out @ p.w_out, RGLRUState(h=h, conv=hist[:, 1:])


# ============================================================ mLSTM =======
class MLSTM(nn.Module):
    """Parameters of one mLSTM block, named as the reference's dict: the
    up-projections to the inner width di = 2·d, q/k/v on it, the
    per-head input and forget gates ``w_if`` (fp32 in any model dtype)
    and the down-projection."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d, dt = cfg.d_model, torch_dtype(cfg)
        di = 2 * d
        kw = dict(dtype=dt, device=device)
        self.w_up = param(d, di, **kw)
        self.w_gate_up = param(d, di, **kw)
        self.wq = param(di, di, **kw)
        self.wk = param(di, di, **kw)
        self.wv = param(di, di, **kw)
        self.w_if = param(di, 2 * cfg.n_heads, dtype=torch.float32,
                          device=device)
        self.w_down = param(di, d, **kw)

    def reset_parameters(self, key: torch.Tensor) -> None:
        """The reference's ``mlstm_init``: ``split(key, 7)`` in the order
        of the parameters."""
        for w, k in zip((self.w_up, self.w_gate_up, self.wq, self.wk,
                         self.wv, self.w_if, self.w_down),
                        prng.split(key, 7)):
            dense_init(w, k)


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, hd, hd) matrix memory, fp32
    n: torch.Tensor   # (B, H, hd) normaliser
    m: torch.Tensor   # (B, H) log-space stabiliser


def mlstm_init_state(cfg, batch: int, device=None) -> MLSTMState:
    nh = cfg.n_heads
    hd = 2 * cfg.d_model // nh
    return MLSTMState(
        c=torch.zeros(batch, nh, hd, hd, dtype=torch.float32, device=device),
        n=torch.zeros(batch, nh, hd, dtype=torch.float32, device=device),
        m=torch.full((batch, nh), -1e30, dtype=torch.float32, device=device))


def _qkv(p, u: torch.Tensor, nh: int):
    """q, k, v (..., H, hd) fp32 from the inner activations u (..., di).
    The reference divides k, still in u's dtype, by ``np.sqrt(hd)``, a
    strongly typed fp32 scalar to JAX: the product of u @ wk is cast to
    fp32 before the divide, not after."""
    hd = u.shape[-1] // nh
    shape = u.shape[:-1] + (nh, hd)
    q = reshape(u @ p.wq, shape).float()
    k = reshape(u @ p.wk, shape).float() / float(np.float32(np.sqrt(hd)))
    v = reshape(u @ p.wv, shape).float()
    return q, k, v


def _mlstm_gates(p, u: torch.Tensor):
    """Log input and forget gates per head, (..., H) fp32 each: u against
    the fp32 ``w_if`` in fp32, as JAX promotes a bf16 u."""
    gf = u.float() @ p.w_if
    h = gf.shape[-1] // 2
    return gf[..., :h], F.logsigmoid(gf[..., h:])


def _one(t: torch.Tensor) -> torch.Tensor:
    """1.0 as a 0-d tensor, for ``torch.maximum``: its gradient splits a
    tie in half, as ``jnp.maximum(·, 1.0)``'s does (``clamp`` would pass
    it whole)."""
    return torch.ones((), dtype=t.dtype, device=t.device)


def mlstm_block(p, x: torch.Tensor, cfg, chunk: int = 256,
                return_state: bool = False):
    """mLSTM mixer (B, S, d) → (B, S, d): the quadratic form when
    S ≤ ``chunk`` and no state is asked for, else the chunkwise form at
    min(chunk, S); with ``return_state``, also the state after the last
    token."""
    b, s, _ = x.shape
    u = x @ p.w_up
    gate = F.silu(x @ p.w_gate_up)
    q, k, v = _qkv(p, u, cfg.n_heads)
    log_i, log_f = _mlstm_gates(p, u)                          # (B, S, H)
    q, k, v, log_i, log_f = map(batch_split_only, (q, k, v, log_i, log_f))
    if s <= chunk and not return_state:
        h = _mlstm_quadratic(q, k, v, log_i, log_f)
    else:
        h, state = _mlstm_chunked(q, k, v, log_i, log_f, min(chunk, s))
    out = (reshape(h, (b, s, -1)).to(x.dtype) * gate) @ p.w_down
    if return_state:
        return out, state
    return out


def _causal(n: int, device) -> torch.Tensor:
    """(1, T, S, 1): key s is visible to query t when s ≤ t."""
    return torch.ones(n, n, dtype=torch.bool, device=device).tril()[
        None, :, :, None]


def _mlstm_quadratic(q, k, v, log_i, log_f):
    """Decay-masked linear-attention form, O(S²) memory:
    h_t = Σ_{s≤t} exp(log_i_s + Σ_{r=s+1..t} log_f_r − m_t)·(q_t·k_s)·v_s,
    over max(|Σ_s exp(…)·(q_t·k_s)|, 1)."""
    cum_f = torch.cumsum(log_f, dim=1)
    a = log_i[:, None] + cum_f[:, :, None] - cum_f[:, None]    # (B,T,S,H)
    a = a.masked_fill(~_causal(q.shape[1], q.device), float("-inf"))
    m = torch.amax(a, dim=2, keepdim=True)                     # (B,T,1,H)
    w = torch.exp(a - m) * torch.einsum("bthd,bshd->btsh", q, k)
    norm = torch.maximum(w.sum(dim=2).abs(), _one(w))
    h = torch.einsum("btsh,bshd->bthd", w, v)
    return h / norm[..., None]


def _mlstm_chunked(q, k, v, log_i, log_f, chunk: int):
    """Chunkwise form, O(S·chunk) memory: within a chunk the quadratic
    form, across chunks the carried (C, n, m). S is padded to a multiple
    of ``chunk`` with tokens whose log input gate is −1e30 (they add
    nothing). Returns h (B, S, H, hd) and the final ``MLSTMState``."""
    b, s, nh, hd = q.shape
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    c_p = q.new_zeros(b, nh, hd, hd)
    n_p = q.new_zeros(b, nh, hd)
    m_p = q.new_full((b, nh), -1e30)
    causal, one = _causal(chunk, q.device), _one(q)
    hs = []
    for t0 in range(0, s + pad, chunk):
        qc, kc, vc, lic, lfc = (t[:, t0:t0 + chunk]
                                for t in (q, k, v, log_i, log_f))
        cum_f = torch.cumsum(lfc, dim=1)                        # (B,L,H)
        a = (lic[:, None] + cum_f[:, :, None] - cum_f[:, None]
             ).masked_fill(~causal, float("-inf"))              # (B,L,L,H)
        inter_log = cum_f + m_p[:, None]
        m_t = torch.maximum(torch.amax(a, dim=2), inter_log)    # (B,L,H)
        w = torch.exp(a - m_t[:, :, None])
        g = torch.exp(inter_log - m_t)
        wqk = w * torch.einsum("bthd,bshd->btsh", qc, kc)
        num_intra = torch.einsum("btsh,bshd->bthd", wqk, vc)
        num_inter = torch.einsum("bthd,bhde->bthe", qc, c_p) * g[..., None]
        den_inter = torch.einsum("bthd,bhd->bth", qc, n_p) * g
        den = torch.maximum((wqk.sum(dim=2) + den_inter).abs(), one)
        hs.append((num_intra + num_inter) / den[..., None])
        # the state at the chunk's end
        cf_end = cum_f[:, -1]                                   # (B,H)
        tok_log = lic + cf_end[:, None] - cum_f                 # (B,L,H)
        m_end = torch.maximum(m_p + cf_end, torch.amax(tok_log, dim=1))
        carry_sc = torch.exp(m_p + cf_end - m_end)
        k_sc = kc * torch.exp(tok_log - m_end[:, None])[..., None]
        c_p = carry_sc[..., None, None] * c_p + torch.einsum(
            "bshd,bshe->bhde", k_sc, vc)
        n_p = carry_sc[..., None] * n_p + k_sc.sum(dim=1)
        m_p = m_end
    return torch.cat(hs, dim=1)[:, :s], MLSTMState(c=c_p, n=n_p, m=m_p)


def mlstm_decode_step(p, x: torch.Tensor, state: MLSTMState, cfg):
    """x: (B, 1, d), one token; O(1) update of (C, n, m)."""
    b = x.shape[0]
    u = (x @ p.w_up)[:, 0]
    gate = F.silu(x @ p.w_gate_up)[:, 0]
    q, k, v = _qkv(p, u, cfg.n_heads)                           # (B,H,hd)
    log_i, log_f = _mlstm_gates(p, u)                           # (B,H)
    m_new = torch.maximum(log_f + state.m, log_i)
    f_sc = torch.exp(log_f + state.m - m_new)[..., None]
    i_sc = torch.exp(log_i - m_new)[..., None]
    c = f_sc[..., None] * state.c + i_sc[..., None] * (
        k[..., :, None] * v[..., None, :])          # C += k ⊗ v, as chunked
    n = f_sc * state.n + i_sc * k
    num = torch.einsum("bhde,bhd->bhe", c, q)
    den = torch.maximum(torch.einsum("bhj,bhj->bh", n, q).abs(), _one(n))
    h = reshape(num / den[..., None], (b, -1))
    out = ((h.to(x.dtype) * gate) @ p.w_down)[:, None]
    return out, MLSTMState(c=c, n=n, m=m_new)


# ============================================================ sLSTM =======
class SLSTM(nn.Module):
    """Parameters of one sLSTM block, named as the reference's dict: the
    i/f/z/o gates from x_t (``w_gates``) and from h_{t−1} (``r_gates``,
    at scale 0.5/√d), their fp32 bias and the out-projection."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d, dt = cfg.d_model, torch_dtype(cfg)
        kw = dict(dtype=dt, device=device)
        self.w_gates = param(d, 4 * d, **kw)
        self.r_gates = param(d, 4 * d, **kw)
        self.b_gates = param(4 * d, dtype=torch.float32, device=device)
        self.w_out = param(d, d, **kw)

    def reset_parameters(self, key: torch.Tensor) -> None:
        """The reference's ``slstm_init``: ``split(key, 3)`` for
        ``w_gates``, ``r_gates`` (at 0.5/√d) and ``w_out``."""
        d = self.w_out.shape[0]
        ks = prng.split(key, 3)
        dense_init(self.w_gates, ks[0])
        dense_init(self.r_gates, ks[1], 0.5 / np.sqrt(d))
        with torch.no_grad():
            self.b_gates.zero_()
        dense_init(self.w_out, ks[2])


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, d) fp32
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def slstm_init_state(cfg, batch: int, device=None) -> SLSTMState:
    z = torch.zeros(batch, cfg.d_model, dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z, h=z, m=torch.full_like(z, -1e30))


def _slstm_cell(p, x_gates: torch.Tensor, st: SLSTMState,
                dtype: torch.dtype, one: torch.Tensor) -> SLSTMState:
    """One time step. ``x_gates`` is x_t @ w_gates cast to fp32; h_{t−1}
    is cast to the input's ``dtype`` for ``r_gates`` and that product
    rounded there, then cast to fp32, as in the reference."""
    pre = x_gates + (st.h.to(dtype) @ p.r_gates).float() + p.b_gates
    it, ft, zt, ot = pre.chunk(4, dim=-1)
    f_m = F.logsigmoid(ft) + st.m
    m_new = torch.maximum(f_m, it)
    i_sc = torch.exp(it - m_new)
    f_sc = torch.exp(f_m - m_new)
    c = f_sc * st.c + i_sc * torch.tanh(zt)
    n = f_sc * st.n + i_sc
    h = torch.sigmoid(ot) * c / torch.maximum(n, one)
    return SLSTMState(c=c, n=n, h=h, m=m_new)


def slstm_block(p, x: torch.Tensor, cfg, return_state: bool = False):
    """sLSTM mixer (B, S, d) → (B, S, d), a loop over the S time steps.
    x_t @ w_gates for every t is one GEMM before the loop: each of its
    rows is the reference's per-step product (the same arithmetic), and
    the loop keeps only what depends on h_{t−1}."""
    x_gates = (x @ p.w_gates).float()                          # (B, S, 4d)
    st = slstm_init_state(cfg, x.shape[0], x.device)
    one = _one(st.n)
    hs = []
    for t in range(x.shape[1]):
        st = _slstm_cell(p, x_gates[:, t], st, x.dtype, one)
        hs.append(st.h)
    out = torch.stack(hs, dim=1).to(x.dtype) @ p.w_out
    if return_state:
        return out, st
    return out


def slstm_decode_step(p, x: torch.Tensor, state: SLSTMState, cfg):
    """x: (B, 1, d), one token."""
    st = _slstm_cell(p, (x[:, 0] @ p.w_gates).float(), state, x.dtype,
                     _one(state.n))
    return (st.h.to(x.dtype) @ p.w_out)[:, None], st
