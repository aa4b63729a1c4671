"""Minimal optimizer substrate (the JAX package's ``optim/sgd.py``):
optax-style pure transforms on dicts of tensors (nested dicts too).

``update(grads, state, params)`` returns new params and a new state and
writes nothing in place. SGD reads its learning rate at the step count
before the update, Adam at the count after it, as the reference does.
RWSADMM itself needs no optimizer: its updates are closed-form
(``core/rwsadmm.py``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

Tree = Any   # a tensor, or a dict of trees


class Optimizer(NamedTuple):
    init: Callable[[Tree], dict]
    update: Callable[..., tuple[Tree, dict]]  # (grads, state, params)


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _zero_count(params) -> torch.Tensor:
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def sgd(lr: float | Callable[[torch.Tensor], torch.Tensor],
        momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        mu = _map(torch.zeros_like, params) if momentum else None
        return {"mu": mu, "count": _zero_count(params)}

    def update(grads, state, params):
        step_lr = lr(state["count"]) if callable(lr) else lr
        if weight_decay:
            grads = _map(lambda g, p: g + weight_decay * p, grads, params)
        mu = None
        if momentum:
            mu = _map(lambda m, g: momentum * m + g, state["mu"], grads)
            grads = mu
        new_params = _map(lambda p, g: p - step_lr * g, params, grads)
        return new_params, {"mu": mu, "count": state["count"] + 1}

    return Optimizer(init, update)


def adam(lr: float | Callable[[torch.Tensor], torch.Tensor],
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _map(torch.zeros_like, params),
                "v": _map(torch.zeros_like, params),
                "count": _zero_count(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        step_lr = lr(count) if callable(lr) else lr
        m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = _map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
        mc = 1.0 - b1 ** count.float()
        vc = 1.0 - b2 ** count.float()

        def leaf(p, m_, v_):
            upd = (m_ / mc) / (torch.sqrt(v_ / vc) + eps)
            if weight_decay:
                upd = upd + weight_decay * p
            return p - step_lr * upd

        return _map(leaf, params, m, v), {"m": m, "v": v, "count": count}

    return Optimizer(init, update)
