"""Mixture-of-Experts FFN (the JAX package's ``models/moe.py``), on one
device or expert parallel over a mesh's "model" axis.

Routing is fp32: a softmax over the router's logits, each token's top-k
experts (ties to the lower index, as ``jax.lax.top_k``) and their weights
renormalised to sum to one. The T·k (token, expert) slots are sorted by
expert, stably, so each expert's slots keep their (t, j) order; a slot's
capacity position is its rank in its expert's run, and a slot at or past
``capacity`` drops (its token gets nothing from that expert). Kept slots
are written into a dense (E·cap + 1, d) buffer whose last row takes every
dropped slot, the experts run as three batched GEMMs with SiLU gating,
and each token sums its kept slots' weighted outputs in ascending expert
order, in the activations' dtype. Every shape follows from the config and
the token count, and nothing is read back to the host, so a decode step
runs it without a sync. Shared (always-on) experts are a SwiGLU ``MLP``
over all tokens.

Expert parallelism (the reference's ``moe_ffn_local`` arguments and
``LM._moe``'s ``shard_map``): :func:`moe_ffn` given shard ``shard_index``
of ``n_shards`` holds that shard's E/n experts. Routing is computed in
full on every shard; slots routed to other shards go to a dummy bucket
past the local experts and drop; the capacity still comes from the
global E; the output is this shard's partial, summed over the process
group ``axis`` when one is given; ZeRO-3 storage (each expert's hidden
dim split over ``gather_axis``) is all-gathered just before use.
:func:`moe_parallel` runs a layer under a ``ShardingCtx``: on DTensors
(the dry-run) it redistributes the inputs to the reference's
``shard_map`` specs, runs the local experts on the local shards, and
sums the partials by redistributing a ``Partial`` result over "model";
on plain tensors (every rank holding the whole layer and the whole
batch, as on a one-rank mesh) each rank takes its own experts and its
slice of the shared expert's hidden dim, and the backward sums the
ranks' gradients of what they share, so every rank ends with the
meshless layer's gradients. A group of one rank issues no collective.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..core import prng
from .layers import MLP, dense_init, mlp, normal_init, param, torch_dtype


class MoE(nn.Module):
    """``router`` (d, E), fp32 in any model dtype; ``w_in``, ``w_gate``
    (E, d, h) and ``w_out`` (E, h, d) in the config's dtype; and, with
    shared experts, ``shared`` (an ``MLP`` of width h·n_shared). Names and
    shapes are the reference's dict's. Calling it runs :func:`moe_ffn`."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        e = cfg.moe
        d, h = cfg.d_model, e.d_expert
        kw = dict(dtype=torch_dtype(cfg), device=device)
        self.cfg = cfg
        self.router = param(d, e.n_experts, dtype=torch.float32,
                            device=device)
        self.w_in = param(e.n_experts, d, h, **kw)
        self.w_gate = param(e.n_experts, d, h, **kw)
        self.w_out = param(e.n_experts, h, d, **kw)
        if e.n_shared_experts:
            self.shared = MLP(d, h * e.n_shared_experts, "silu", **kw)
        #: the model's ``ShardingCtx`` (None: every expert local)
        self.ctx = None

    def reset_parameters(self, key: torch.Tensor) -> None:
        """The reference's ``moe_init``: ``split(key, 5)`` for the router,
        ``w_in``, ``w_gate``, ``w_out`` (each (E, n_in, n_out) at
        1/√n_in) and the shared experts, whose ``split(ks[4], 3)`` goes to
        ``w_in``, ``w_gate`` and ``w_out`` in that order (not the
        ``MLP``'s)."""
        d, h = self.w_in.shape[1:]
        ks = prng.split(key, 5)
        dense_init(self.router, ks[0])
        normal_init(self.w_in, ks[1], 1.0 / np.sqrt(d))
        normal_init(self.w_gate, ks[2], 1.0 / np.sqrt(d))
        normal_init(self.w_out, ks[3], 1.0 / np.sqrt(h))
        if hasattr(self, "shared"):
            k_in, k_gate, k_out = prng.split(ks[4], 3)
            dense_init(self.shared.w_in, k_in)
            dense_init(self.shared.w_gate, k_gate)
            dense_init(self.shared.w_out, k_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ctx is None or self.ctx.mesh is None:
            return moe_ffn(self, x, self.cfg)
        return moe_parallel(self, x, self.cfg, self.ctx)


def capacity(n_tokens: int, cfg) -> int:
    """Slots per expert: ⌈factor·T·k/E⌉, at most T and at least 4."""
    e = cfg.moe
    c = int(np.ceil(e.capacity_factor * n_tokens * e.top_k / e.n_experts))
    return max(4, min(c, n_tokens))


def route(p, xf: torch.Tensor, cfg):
    """xf (T, d) → each token's top-k weights (T, k) fp32, renormalised,
    and experts (T, k), in descending probability."""
    probs = torch.softmax(xf.float() @ p.router, dim=-1)
    # A stable descending sort puts equal probabilities in index order,
    # as jax.lax.top_k does; torch.topk promises no order for ties.
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    return top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9), top_i


class Dispatch(NamedTuple):
    """The T·k slots sorted by expert: ``order`` (flat (t, j) index of
    each), its expert, token and weight, its buffer row (``slot``; the
    overflow row E·cap when dropped) and whether it is kept."""

    order: torch.Tensor
    expert: torch.Tensor
    token: torch.Tensor
    weight: torch.Tensor
    slot: torch.Tensor
    valid: torch.Tensor


def dispatch(top_w: torch.Tensor, top_i: torch.Tensor, n_experts: int,
             cap: int, lo: int = 0, n_total: int | None = None) -> Dispatch:
    """The slots of ``n_experts`` local experts, global indices ``lo`` on,
    of ``n_total`` (default: all local). A slot routed to another shard
    sorts into the dummy bucket ``n_experts`` and is not kept."""
    t, k = top_i.shape
    flat_e = top_i.reshape(-1)
    sharded = n_total is not None and n_total != n_experts
    if sharded:
        local = flat_e - lo
        flat_e = torch.where((local >= 0) & (local < n_experts), local,
                             torch.full_like(local, n_experts))
    order = torch.argsort(flat_e, stable=True)
    s_e = flat_e[order]
    # Each expert's first sorted slot, found on the device (bincount
    # would read its largest key back to the host).
    starts = torch.searchsorted(
        s_e, torch.arange(n_experts + sharded, device=s_e.device))
    pos = torch.arange(t * k, device=s_e.device) - starts[s_e]
    valid = pos < cap
    if sharded:
        valid = valid & (s_e < n_experts)
    slot = torch.where(valid, s_e * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    return Dispatch(order=order, expert=s_e, token=order // k,
                    weight=top_w.reshape(-1)[order], slot=slot, valid=valid)


def dropped_slots(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """The (token, expert) slots of x (B, S, d) past their expert's
    capacity: a 0-d tensor, left on the device."""
    xf = x.reshape(-1, x.shape[-1])
    plan = dispatch(*route(p, xf, cfg), cfg.moe.n_experts,
                    capacity(xf.shape[0], cfg))
    return (~plan.valid).sum()


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _GatherHidden(torch.autograd.Function):
    """ZeRO-3: the ranks' slices of ``w`` along ``dim`` concatenated, in
    rank order (``all_gather(..., tiled=True)``). Backward: this rank's
    slice of the gradient. The ranks of ``group`` run the same tokens
    (the plain-tensor path), so each holds the whole gradient of the
    gathered weight, and its slice is its own; the sum over the ranks
    of the stored weight's slices is :class:`_Replicated`'s."""

    @staticmethod
    def forward(ctx, w, dim, group):
        n = dist.get_world_size(group)
        ctx.dim, ctx.size = dim, w.shape[dim]
        ctx.rank = dist.get_rank(group)
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


class _SumPartials(torch.autograd.Function):
    """The ranks' partial outputs summed over ``group``, every rank
    getting the whole. Backward: the gradient as it is, since every rank
    computes the same loss from the sum (Megatron's reduce from the
    model-parallel region)."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """A tensor each rank of ``group`` holds whole and uses for its own
    share of the work (its experts, its slice of a hidden dim). Forward:
    the tensor. Backward: the ranks' gradients summed, so every rank holds
    the whole gradient (Megatron's copy to the model-parallel region)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _replicated(t: torch.Tensor, *groups) -> torch.Tensor:
    for group in groups:
        if _group_size(group) > 1:
            t = _Replicated.apply(t, group)
    return t


def moe_ffn(p, x: torch.Tensor, cfg, *, axis=None, shard_index: int = 0,
            n_shards: int = 1, gather_axis=None) -> torch.Tensor:
    """x (B, S, d) → (B, S, d): the reference's ``moe_ffn_local``. ``p``
    holds shard ``shard_index`` of ``n_shards``' experts (all of them by
    default) and, with shared experts, its slice of their hidden dim.
    ``axis``: the process group the partial output is summed over;
    ``gather_axis``: the group each expert's hidden dim is split over
    (ZeRO-3 storage), gathered here. The ranks of both groups run the
    same tokens and compute the same loss, and the backward assumes it
    (:class:`_SumPartials`, :class:`_GatherHidden`). A group of one rank
    issues no collective."""
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    w_in, w_gate, w_out = p.w_in, p.w_gate, p.w_out
    if _group_size(gather_axis) > 1:
        w_in = _GatherHidden.apply(w_in, 2, gather_axis)
        w_gate = _GatherHidden.apply(w_gate, 2, gather_axis)
        w_out = _GatherHidden.apply(w_out, 1, gather_axis)
    n_exp = w_in.shape[0]
    if n_exp * n_shards != e.n_experts:
        raise ValueError(f"{n_shards} shards of {n_exp} experts, the "
                         f"config has {e.n_experts}")
    cap = capacity(t, cfg)
    plan = dispatch(*route(p, xf, cfg), n_exp, cap,
                    lo=int(shard_index) * n_exp, n_total=e.n_experts)
    keep = plan.valid[:, None]

    # gather tokens into the (E·cap) dispatch buffer; dropped slots all
    # land, as zeros, on the overflow row, which is cut away
    rows = torch.where(keep, xf[plan.token], 0.0)
    buf = xf.new_zeros(n_exp * cap + 1, d).index_copy(0, plan.slot, rows)
    buf = buf[:-1].reshape(n_exp, cap, d)

    # expert GEMMs, dense and batched: E·cap·d·h·3·2 FLOPs
    hidd = torch.bmm(buf, w_in)
    hidd = F.silu(torch.bmm(buf, w_gate)) * hidd
    out_e = torch.bmm(hidd, w_out).reshape(n_exp * cap, d)

    # combine: each slot's output times its weight (cast to x's dtype
    # first, as the reference), then each token's k slots summed in the
    # sorted (expert-ascending) order, as the reference's scatter-add
    # applies them; a gather and fixed adds, so runs repeat bit for bit
    contrib = torch.where(
        keep, out_e[plan.slot.clamp(max=n_exp * cap - 1)]
        * plan.weight[:, None].to(x.dtype), 0.0)
    rank = torch.empty_like(plan.order).scatter_(
        0, plan.order, torch.arange(t * e.top_k, device=x.device))
    per_token = contrib[rank.reshape(t, e.top_k).sort(dim=-1).values]
    out = per_token[:, 0]
    for j in range(1, e.top_k):
        out = out + per_token[:, j]

    if getattr(p, "shared", None) is not None:
        out = out + mlp(p.shared, xf, "silu")
    if _group_size(axis) > 1:
        out = _SumPartials.apply(out, axis)
    return out.reshape(b, s, d)


class _Shard(NamedTuple):
    """One shard's MoE params, attribute-named as the module's."""

    router: torch.Tensor
    w_in: torch.Tensor
    w_gate: torch.Tensor
    w_out: torch.Tensor
    shared: object = None


class _SharedShard(NamedTuple):
    w_in: torch.Tensor
    w_gate: torch.Tensor
    w_out: torch.Tensor


def shard_params(p, index: int, n: int, *, hidden_index: int = 0,
                 hidden_n: int = 1) -> _Shard:
    """Shard ``index`` of ``n`` of an ``MoE``'s params: experts
    [index·E/n, (index + 1)·E/n), each expert's hidden dim cut to slice
    ``hidden_index`` of ``hidden_n`` (ZeRO-3 storage), and the shared
    expert's hidden dim cut to slice ``index`` of ``n`` (the reference's
    ``shard_map`` specs: ``P(None, "model")`` for its w_in and w_gate,
    ``P("model", None)`` for its w_out)."""
    def cut(w, dim, i, m):
        step = w.shape[dim] // m
        return w.narrow(dim, i * step, step)

    shared = None
    if getattr(p, "shared", None) is not None:
        sh = p.shared
        shared = _SharedShard(cut(sh.w_in, 1, index, n),
                              cut(sh.w_gate, 1, index, n),
                              cut(sh.w_out, 0, index, n))
    return _Shard(p.router,
                  cut(cut(p.w_in, 0, index, n), 2, hidden_index, hidden_n),
                  cut(cut(p.w_gate, 0, index, n), 2, hidden_index, hidden_n),
                  cut(cut(p.w_out, 0, index, n), 1, hidden_index, hidden_n),
                  shared)


def moe_parallel(p, x: torch.Tensor, cfg, ctx) -> torch.Tensor:
    """An MoE layer expert parallel over ``ctx.mesh``'s model axis (the
    reference's ``LM._moe`` under a mesh); see the module docstring."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _moe_dtensor(p, x, cfg, ctx)
    mesh, mp = ctx.mesh, ctx.model_axis
    n, idx = mesh.size(mesh.mesh_dim_names.index(mp)), mesh.get_local_rank(mp)
    za = "data" if ctx.zero3_moe else None
    hidden_n = 1 if za is None else mesh.size(mesh.mesh_dim_names.index(za))
    hidden_idx = 0 if za is None else mesh.get_local_rank(za)
    mg = mesh.get_group(mp)
    zg = None if za is None else mesh.get_group(za)
    # every rank holds the whole layer and the whole batch: the gradients
    # of what it uses for its own share are summed over the ranks sharing
    shared = None
    if getattr(p, "shared", None) is not None:
        sh = p.shared
        shared = _SharedShard(*(_replicated(w, mg)
                                for w in (sh.w_in, sh.w_gate, sh.w_out)))
    whole = _Shard(_replicated(p.router, mg),
                   *(_replicated(w, mg, zg)
                     for w in (p.w_in, p.w_gate, p.w_out)), shared)
    local = shard_params(whole, idx, n, hidden_index=hidden_idx,
                         hidden_n=hidden_n)
    return moe_ffn(local, _replicated(x, mg), cfg, axis=mg,
                   shard_index=idx, n_shards=n, gather_axis=zg)


def _moe_dtensor(p, x, cfg, ctx):
    """The DTensor form: inputs redistributed to the ``shard_map`` specs
    (tokens over the data axes, experts over "model" and, ZeRO-3, stored
    over "data" but gathered here; the shared expert's hidden dim over
    "model"), :func:`moe_ffn` on the local shards, and the partials summed
    by redistributing over "model"."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, \
        Shard

    mesh, mp = ctx.mesh, ctx.model_axis
    names = list(mesh.mesh_dim_names)
    n = mesh.size(names.index(mp))
    data = [i for i, a in enumerate(names) if a in ctx.data_axes]
    n_data = 1
    for i in data:
        n_data *= mesh.size(i)
    batch_split = x.shape[0] % n_data == 0

    def placed(spec: dict):
        out = [Replicate() for _ in names]
        for i, pl in spec.items():
            out[i] = pl
        return out

    def local(t, spec: dict):
        return t.redistribute(mesh, placed(spec)).to_local()

    m = names.index(mp)
    x_spec = {i: Shard(0) for i in data} if batch_split else {}
    w_spec = {m: Shard(0)}
    shared = None
    if getattr(p, "shared", None) is not None:
        sh = p.shared
        shared = _SharedShard(local(sh.w_in, {m: Shard(1)}),
                              local(sh.w_gate, {m: Shard(1)}),
                              local(sh.w_out, {m: Shard(0)}))
    params = _Shard(local(p.router, {}), local(p.w_in, w_spec),
                    local(p.w_gate, w_spec), local(p.w_out, w_spec), shared)
    xl = local(x, x_spec)
    out = moe_ffn(params, xl, cfg, shard_index=mesh.get_local_rank(mp),
                  n_shards=n)
    partial = placed({**x_spec, m: Partial()})
    return DTensor.from_local(out, mesh, partial, run_check=False,
                              shape=x.shape, stride=x.stride()
                              ).redistribute(mesh, placed(x_spec))


def router_aux_loss(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Load-balance auxiliary loss (Switch-style): E·Σ_e f_e·p_e, with f_e
    the share of tokens whose top expert is e and p_e the mean router
    probability of e."""
    n_exp = cfg.moe.n_experts
    xf = x.reshape(-1, x.shape[-1]).float()
    t = xf.shape[0]
    probs = torch.softmax(xf @ p.router, dim=-1)
    top1 = probs.argmax(dim=-1)
    frac = torch.zeros(n_exp, device=x.device).scatter_add_(
        0, top1, torch.ones(t, device=x.device)) / t
    return n_exp * torch.sum(frac * probs.mean(dim=0))
