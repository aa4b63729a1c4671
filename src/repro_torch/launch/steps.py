"""Step functions (the JAX package's ``launch/steps.py``): one RWSADMM
zone round on a language model, greedy prefill and one-token decode.

The train step holds the active client's personalized params x, its dual
z and the mobile server's token y as dicts keyed by the ``LM``'s
parameter names, takes the loss and gradient at x through
``functional_call``, and updates each leaf with ``core/rwsadmm``'s
closed form (plain torch, as the reference's step is plain ``jnp``).

Each serving step returns the next token ids (B, 1), the logits they
were taken from (B, vocab) fp32, and the cache.
"""
from __future__ import annotations

from typing import NamedTuple

import inspect

import torch
from torch.func import functional_call

from ..core import rwsadmm
from ..core.rwsadmm import RWSADMMHparams


class TrainState(NamedTuple):
    """RWSADMM state of the active zone: dicts of tensors keyed by the
    model's parameter names, and κ as a 0-d fp32 tensor."""

    x: dict          # active client's personalized params
    z: dict          # dual
    y: dict          # mobile-server token
    kappa: torch.Tensor


def init_train_state(params: dict, hp: RWSADMMHparams) -> TrainState:
    """x = y = ``params`` (shared, never written in place), z = 0."""
    kappa_device = next(iter(params.values())).device
    return TrainState(
        x=dict(params), z={k: torch.zeros_like(v) for k, v in params.items()},
        y=dict(params),
        kappa=torch.tensor(hp.kappa, dtype=torch.float32,
                           device=kappa_device))


def make_train_step(model, hp: RWSADMMHparams, n_total: float = 20.0, *,
                    ce_impl: str = "gather"):
    """One RWSADMM round: the stochastic gradient at x, then the x/z/y
    update leaf by leaf and κ ← κ·``kappa_decay``. Returns
    ``train_step(state, batch) -> (state, loss)``.

    n_total: the client population n (the y fold's 1/n, see
    ``core.rwsadmm.y_update``). ce_impl: the loss's cross-entropy form
    (``LM.loss``); an ``EncDecLM``'s loss has one form and takes none,
    as in the reference's step.

    Dtypes follow the reference's promotion: its κ is a strong fp32
    scalar, so against bf16 leaves z (and with it c_new and y) turn fp32
    in the first round and x in the second. torch lets a 0-d tensor take
    the leaf's dtype, so κ enters the update as a (1,) tensor, which
    promotes as the reference's does."""

    loss_kw = ({"ce_impl": ce_impl}
               if "ce_impl" in inspect.signature(model.forward).parameters
               else {})

    def train_step(state: TrainState, batch: dict):
        x = {k: v.detach().requires_grad_() for k, v in state.x.items()}
        loss = functional_call(model, x, (batch,), loss_kw)
        grads = torch.autograd.grad(loss, list(x.values()))
        kappa = state.kappa.reshape(1)
        new_x, new_z, new_y = {}, {}, {}
        with torch.no_grad():
            for k, g in zip(x, grads):
                client, c_new, c_old = rwsadmm.client_round(
                    rwsadmm.ClientState(x=state.x[k], z=state.z[k]),
                    state.y[k], g, hp, kappa)
                new_x[k], new_z[k] = client.x, client.z
                new_y[k] = rwsadmm.y_update(state.y[k], c_new, c_old,
                                            n_total)
        return TrainState(x=new_x, z=new_z, y=new_y,
                          kappa=state.kappa * hp.kappa_decay), loss.detach()

    return train_step


def make_prefill_step(model, max_len: int):
    """batch → (next_tok (B, 1), logits of the last position, cache)."""

    @torch.no_grad()
    def prefill_step(batch):
        logits, cache = model.prefill(batch, max_len)
        last = logits[:, -1].clone()    # not a view that keeps all logits
        return last.argmax(dim=-1, keepdim=True), last, cache

    return prefill_step


def make_serve_step(model):
    """(cache, tokens (B, 1)) → (next_tok (B, 1), logits, cache)."""

    @torch.no_grad()
    def serve_step(cache, tokens):
        logits, cache = model.decode_step(cache, tokens)
        return logits.argmax(dim=-1, keepdim=True), logits, cache

    return serve_step
