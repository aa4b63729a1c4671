"""Walkman-style random-walk consensus ADMM (Mao et al. 2020, paper [35];
port of ``repro/core/walkman.py`` on flat rows).

The closest prior algorithm to RWSADMM: a walker token y performs a
random walk over the agents, exactly one agent is activated per
iteration, and the updates enforce *consensus* (x_i = y for all i)
instead of RWSADMM's hard inequality proximity. The gradient-type
variant (Walkman's inexact update):

    x_i ← y' − (1/β)(g_i + z_i')
    z_i ← z_i' + β (x_i − y')
    y  ← y' + (1/n)[(x_i + z_i/β) − (x_i' + z_i'/β)]

Client x and z are ``(n, P)`` rows or one client's ``(P,)`` (or
``(1, P)``) slice of them; y is ``(P,)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class WalkmanClientState(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor


class WalkmanServerState(NamedTuple):
    y: torch.Tensor       # (P,)
    round: torch.Tensor   # 0-d int32


def init_states(template: torch.Tensor, n_clients: int, *,
                warm: bool = False):
    """x = z = 0 for every client, y = 0; ``template`` is a flat ``(P,)``
    vector (its shape, dtype and device are used). ``warm`` starts every
    client's x at ``template`` instead."""
    z = template.new_zeros((n_clients,) + tuple(template.shape))
    x = template.repeat(n_clients, 1) if warm else z.clone()
    return (WalkmanClientState(x=x, z=z),
            WalkmanServerState(y=torch.zeros_like(template),
                               round=torch.tensor(0, dtype=torch.int32,
                                                  device=template.device)))


def client_round(client: WalkmanClientState, y_prev: torch.Tensor,
                 grad: torch.Tensor, beta: float):
    """The active client's x and z, and its contribution
    c = x + z/β after and before."""
    x_new = y_prev - (grad + client.z) / beta
    z_new = client.z + beta * (x_new - y_prev)
    c_new = x_new + z_new / beta
    c_old = client.x + client.z / beta
    return WalkmanClientState(x=x_new, z=z_new), c_new, c_old


def y_update(y_prev: torch.Tensor, c_new: torch.Tensor, c_old: torch.Tensor,
             n: int) -> torch.Tensor:
    return y_prev + (c_new - c_old) / n
