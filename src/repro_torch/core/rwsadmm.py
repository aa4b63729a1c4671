"""RWSADMM: Random Walk Stochastic ADMM (paper §3.1, Algorithm 1).

The closed-form updates (reference: ``repro/core/rwsadmm.py``):

    x ← y' − g/β + sgn(y' − x') ⊙ (z' − βε)/β        (derived Eq. 10 solver)
    z ← z' + κβ·(x − y' − ε)                         (Eq. 15, κ decayed)
    y ← y' + (1/n)·[ c(x, z) − c(x', z') ]           (Eq. 14, 1/n not 1/n_i)
        with contribution  c(x, z) = x − (z/β + ε) ⊙ sgn(y' − x)

ε here is ``hp.eps_half`` (the split ε/2 of Eq. 7), as in the reference.
``literal_eq11`` gives the paper's printed Eq. 11 for the ablation, and
the diagnostics at the end (L_β, M_β, the constraint residuals, the β
threshold) monitor the theory of §4.
Every update is elementwise, so the functions below take tensors of any
shape and broadcast: a client row ``(P,)`` or a zone ``(Z, P)`` against
the token ``(P,)``. ``torch.sign(0) == 0``, like ``jnp.sign``.

The order of operations follows the reference expression by expression,
so fp32 results agree with it to the last few bits.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class RWSADMMHparams:
    """Hyperparameters (paper App. D.3): barrier β, initial dual step κ
    (decayed ×``kappa_decay`` per round), constraint relaxation ε."""

    beta: float = 10.0
    kappa: float = 0.001
    kappa_decay: float = 0.99
    epsilon: float = 1e-5

    @property
    def eps_half(self) -> float:
        return self.epsilon / 2.0


class ClientState(NamedTuple):
    """Per-client ADMM variables: flat ``(..., P)`` fp32 tensors."""

    x: torch.Tensor  # personalized model parameters
    z: torch.Tensor  # dual variable


class ServerState(NamedTuple):
    """The token the mobile server carries."""

    y: torch.Tensor      # (P,) local-proximity variable (Eq. 7)
    kappa: torch.Tensor  # 0-d fp32 dual step size, decayed per round
    round: torch.Tensor  # 0-d int32 iteration counter k


def _server(y: torch.Tensor, hp: RWSADMMHparams) -> ServerState:
    return ServerState(
        y=y,
        kappa=torch.tensor(hp.kappa, dtype=torch.float32, device=y.device),
        round=torch.tensor(0, dtype=torch.int32, device=y.device),
    )


def init_states(template: torch.Tensor, hp: RWSADMMHparams,
                n_clients: int | None = None):
    """Paper Eq. (32): x⁰ = z⁰ = 0, y¹ = 0. ``template`` is a flat
    ``(P,)`` parameter vector (its shape, dtype and device are used).
    With ``n_clients`` the client state is stacked ``(n, P)``."""
    shape = template.shape if n_clients is None \
        else (n_clients,) + tuple(template.shape)
    client = ClientState(x=template.new_zeros(shape),
                         z=template.new_zeros(shape))
    return client, _server(torch.zeros_like(template), hp)


def init_states_warm(params: torch.Tensor, hp: RWSADMMHparams,
                     n_clients: int) -> tuple[ClientState, ServerState]:
    """Warm start from one model init: every x_i = y = params, z = 0,
    which keeps Eq. (32)'s invariant y = (1/n)Σ(x_i − z_i/β). The client
    buffers are real ``(n, P)`` copies (the trainer updates them in
    place)."""
    x = params.unsqueeze(0).repeat(n_clients, 1)
    client = ClientState(x=x, z=torch.zeros_like(x))
    return client, _server(params.clone(), hp)


def x_update(y_prev, x_prev, z_prev, grad, hp: RWSADMMHparams, *,
             literal_eq11: bool = False):
    """Solver of the linearized x-subproblem (Eq. 10):
    x = y' − g/β + sgn(y' − x') ⊙ (z' − βε)/β. ``literal_eq11`` takes
    the paper's printed Eq. 11 instead, x = y' + sgn(y' − x')⊙(z' − ε −
    g)/β, which never moves from Eq. 32's initialization (sgn(0) = 0);
    the ablation benchmark shows it."""
    beta, eps = hp.beta, hp.eps_half
    s = torch.sign(y_prev - x_prev)
    if literal_eq11:
        return y_prev + (s * (z_prev - eps - grad)) / beta
    return y_prev - grad / beta + s * (z_prev - beta * eps) / beta


def z_update(x_new, y_prev, z_prev, hp: RWSADMMHparams, kappa):
    """Eq. (15): z = z' + κβ·(x − y' − ε)."""
    beta, eps = hp.beta, hp.eps_half
    return z_prev + kappa * beta * (x_new - y_prev - eps)


def contribution(x, z, y_ref, hp: RWSADMMHparams):
    """c(x, z) = x − (z/β + ε) ⊙ sgn(y' − x)   (the bracket of Eq. 13/14)."""
    beta, eps = hp.beta, hp.eps_half
    return x - (z / beta + eps) * torch.sign(y_ref - x)


def y_update(y_prev, c_new, c_old, n_total):
    """Eq. (14) incremental y-update with 1/n (all clients), not the
    printed 1/n_i: only 1/n keeps Eq. (32)'s running-average invariant
    y = (1/n)Σ_i(x_i − z_i/β) (see the reference docstring)."""
    return y_prev + (c_new - c_old) / n_total


def subproblem_grad(x, y_prev, z, grad_f, hp: RWSADMMHparams):
    """(Sub)gradient of the x-subproblem (Eq. 9):
    ∇F = ∇f(x) + sgn(x − y')⊙(z − βε) + β(x − y')."""
    beta, eps = hp.beta, hp.eps_half
    t = x - y_prev
    return grad_f + torch.sign(t) * (z - beta * eps) + beta * t


def client_round(client: ClientState, y_prev, grad, hp: RWSADMMHparams,
                 kappa, *, literal_eq11: bool = False):
    """One client's (or, broadcast, a whole zone's) closed-form update.
    Returns the new state and the (c_new, c_old) contribution pair."""
    c_old = contribution(client.x, client.z, y_prev, hp)
    x_new = x_update(y_prev, client.x, client.z, grad, hp,
                     literal_eq11=literal_eq11)
    z_new = z_update(x_new, y_prev, client.z, hp, kappa)
    c_new = contribution(x_new, z_new, y_prev, hp)
    return ClientState(x=x_new, z=z_new), c_new, c_old


def zone_round(clients: ClientState, y_prev, grads, hp: RWSADMMHparams,
               kappa, n_total):
    """Multi-client zone update (paper Eq. 31) without padding: every
    row of ``clients``/``grads`` ``(S, P)`` is live, and y folds their
    summed contribution deltas at 1/n."""
    new, c_new, c_old = client_round(clients, y_prev, grads, hp, kappa)
    return new, y_prev + torch.sum(c_new - c_old, dim=0) / n_total


def zone_round_masked(clients: ClientState, y_prev, grads, mask,
                      hp: RWSADMMHparams, kappa, n_total):
    """Masked zone round (paper Eq. 31). ``clients``/``grads`` are
    ``(Z, P)`` with a padded zone axis, ``mask`` ``(Z,)`` marks live
    slots: padded slots pass x/z through and fold zero into y."""
    new, c_new, c_old = client_round(clients, y_prev, grads, hp, kappa)
    m = mask.reshape(-1, 1)
    keep_x = m * new.x + (1.0 - m) * clients.x
    keep_z = m * new.z + (1.0 - m) * clients.z
    y_new = y_prev + torch.sum(m * (c_new - c_old), dim=0) / n_total
    return ClientState(x=keep_x, z=keep_z), y_new


def multizone_round_masked(clients: ClientState, ys, grads, mask,
                           hp: RWSADMMHparams, kappa, n_total):
    """K simultaneous zone rounds (fleet mode): :func:`zone_round_masked`
    over a leading walker axis. ``clients``/``grads`` are ``(K, Z, P)``,
    ``ys`` the ``(K, P)`` token stack, ``mask`` ``(K, Z)``. Each walker
    folds only its own zone into its own token; the caller keeps the K
    zones disjoint (``markov.plan_fleet_zone_round``). The plain oracle
    of ``ops.multizone_fused_update``."""
    new, c_new, c_old = client_round(clients, ys.unsqueeze(1), grads, hp,
                                     kappa)
    m = mask.unsqueeze(-1)
    keep_x = m * new.x + (1.0 - m) * clients.x
    keep_z = m * new.z + (1.0 - m) * clients.z
    y_new = ys + torch.sum(m * (c_new - c_old), dim=1) / n_total
    return ClientState(x=keep_x, z=keep_z), y_new


def server_round_done(server: ServerState, y_new,
                      hp: RWSADMMHparams) -> ServerState:
    """Advance the server token: store y, decay κ (Algorithm 1)."""
    return ServerState(y=y_new, kappa=server.kappa * hp.kappa_decay,
                       round=server.round + 1)


# ---------------------------------------------------------------------------
# Theory diagnostics (Eq. 7, 8, 25; Lemma 4.7) for monitoring and tests.
# ---------------------------------------------------------------------------

def augmented_lagrangian(y, xs: ClientState, losses,
                         hp: RWSADMMHparams) -> torch.Tensor:
    """L_β(y, X; Z) of Eq. (8) with the one token y ``(P,)``, stacked
    client states ``(n, P)`` and per-client losses f_i(x_i) ``(n,)``."""
    beta, eps = hp.beta, hp.eps_half
    r = torch.abs(y.unsqueeze(0) - xs.x) - eps      # |y − x_i| − ε
    per_client = torch.sum(xs.z * r, dim=1) \
        + (beta / 2.0) * torch.sum(r * r, dim=1)
    return (torch.sum(losses) + torch.sum(per_client)) / losses.shape[0]


def lyapunov_m(l_beta, last_x_delta_sq, lipschitz: float, n: int):
    """M_β = L_β + (L²/n) Σ_i ‖x_i^{τ(k,i)+1} − x_i^{τ(k,i)}‖² (Eq. 25,
    Lemma B.4); ``last_x_delta_sq`` is each client's squared norm of its
    latest x update."""
    return l_beta + (lipschitz**2 / n) * torch.sum(last_x_delta_sq)


def constraint_violation(y, xs_stacked, hp: RWSADMMHparams) -> torch.Tensor:
    """max_i ‖max(|y − x_i| − ε/2, 0)‖_∞: the residual of Eq. (7)'s hard
    constraint, 0 at feasibility."""
    v = torch.clamp(torch.abs(y.unsqueeze(0) - xs_stacked) - hp.eps_half,
                    min=0.0)
    return torch.max(v)


def pairwise_violation(xs_stacked, adjacency, hp: RWSADMMHparams
                       ) -> torch.Tensor:
    """max over edges (i, j) of ‖max(|x_i − x_j| − ε, 0)‖_∞: Eq. (1)'s
    original constraint. ``adjacency`` is an (n, n) bool tensor."""
    diff = torch.abs(xs_stacked.unsqueeze(1) - xs_stacked.unsqueeze(0))
    v = torch.clamp(diff - hp.epsilon, min=0.0).amax(dim=2)
    return torch.max(torch.where(adjacency, v, torch.zeros_like(v)))


def beta_lower_bound(lipschitz: float) -> float:
    """Theory threshold β > 2L² + L + 2 (Lemma 4.7, Theorem 4.8)."""
    return 2.0 * lipschitz**2 + lipschitz + 2.0
