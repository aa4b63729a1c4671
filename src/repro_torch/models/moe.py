"""Mixture-of-Experts FFN (the JAX package's ``models/moe.py``) with every
expert on one device.

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

The reference's per-shard arguments of ``moe_ffn_local`` (``axis``,
``shard_index``, ``gather_axis``) and ``LM._moe``'s ``shard_map`` belong
to its mesh path, ROADMAP Queue 1 item 8.7.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
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
        return moe_ffn(self, x, self.cfg)


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
             cap: int) -> Dispatch:
    t, k = top_i.shape
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    s_e = flat_e[order]
    # Each expert's first sorted slot, found on the device (bincount
    # would read its largest key back to the host).
    starts = torch.searchsorted(
        s_e, torch.arange(n_experts, device=s_e.device))
    pos = torch.arange(t * k, device=s_e.device) - starts[s_e]
    valid = pos < cap
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


def moe_ffn(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (B, S, d) → (B, S, d): the reference's ``moe_ffn_local`` with all
    experts local and no collective."""
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    n_exp = p.w_in.shape[0]
    cap = capacity(t, cfg)
    plan = dispatch(*route(p, xf, cfg), n_exp, cap)
    keep = plan.valid[:, None]

    # gather tokens into the (E·cap) dispatch buffer; dropped slots all
    # land, as zeros, on the overflow row, which is cut away
    rows = torch.where(keep, xf[plan.token], 0.0)
    buf = xf.new_zeros(n_exp * cap + 1, d).index_copy(0, plan.slot, rows)
    buf = buf[:-1].reshape(n_exp, cap, d)

    # expert GEMMs, dense and batched: E·cap·d·h·3·2 FLOPs
    hidd = torch.bmm(buf, p.w_in)
    hidd = F.silu(torch.bmm(buf, p.w_gate)) * hidd
    out_e = torch.bmm(hidd, p.w_out).reshape(n_exp * cap, d)

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

    if hasattr(p, "shared"):
        out = out + mlp(p.shared, xf, "silu")
    return out.reshape(b, s, d)


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
