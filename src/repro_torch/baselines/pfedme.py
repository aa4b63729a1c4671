"""pFedMe (Dinh et al. 2020), Moreau-envelope personalization (port of
``repro/baselines/pfedme.py``).

Per selected client, R local rounds; each solves the prox subproblem
θ̃ ≈ argmin_θ f_i(θ; ξ) + (λ/2)||θ − w_i||² with K inner SGD steps on one
minibatch, then w_i ← w_i − ηλ(w_i − θ̃). Server: w ← (1−β)w + β·mean(w_i).
On the lazy plane (``data`` a ``ClientDataFactory``) the cohort's rows
come from the bounded store, and the evaluation personalizes every
resident slot, its keys slot-indexed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import prng
from ..fl.base import CohortTrainer, cohort_mean, keep_at, reject_unported, \
    step_keys
from .perfedavg import _chunks

#: the seed of the evaluation's key, ``PRNGKey(99)`` as in the reference
EVAL_SEED = 99


class PFedMeState(NamedTuple):
    w: torch.Tensor   # (P,)


class PFedMeTrainer(CohortTrainer):
    name = "pfedme"

    def __init__(self, model, data, *, lam: float = 15.0,
                 inner_lr: float = 0.05, inner_steps: int = 5,
                 local_rounds: int = 5, eta: float = 0.05,
                 server_beta: float = 1.0, clients_per_round: int = 10,
                 batch_size: int = 20, device=None, scenario=None,
                 seed: int = 0, telemetry=None, store_capacity: int = 4096,
                 prefetch: bool = False, mesh=None, **unported):
        reject_unported(unported)
        super().__init__(model, data, batch_size, device=device,
                         scenario=scenario, seed=seed, telemetry=telemetry,
                         store_capacity=store_capacity, prefetch=prefetch,
                         mesh=mesh)
        self.m = int(min(clients_per_round, self.n_clients))
        self.lam, self.inner_lr = lam, inner_lr
        self.inner_steps, self.local_rounds = inner_steps, local_rounds
        self.eta, self.server_beta = eta, server_beta

    def init_state(self, seed: int = 0, params: torch.Tensor | None = None
                   ) -> PFedMeState:
        if self.store is not None:
            self._reset_store()
        return PFedMeState(w=self.initial_params(seed, params))

    def prox_solve(self, w_i: torch.Tensor, clients, idx, keep=None):
        """K inner SGD steps from θ = w_i ``(m, P)`` on
        h(θ) = f(θ; ξ) + λ/2||θ − w_i||², one batch ``idx`` ``(m, B)``
        (and one set of keep masks) for all K, as pFedMe samples."""
        theta = w_i
        for _ in range(self.inner_steps):
            _, gf = self.zone_loss_and_grad(theta, clients, idx, keep)
            # ∇ of (λ/2)·Σ(θ − w)² rounded as the reference's autodiff
            # rounds it: (0.5·λ) · (2·(θ − w)).
            g = gf + (0.5 * self.lam) * (2.0 * (theta - w_i))
            theta = theta - self.inner_lr * g
        return theta

    def round_keys(self, key):
        """Client c's local round r: ``split(split(key, m)[c], R)[r]``,
        one batch (and one set of keep masks) per prox solve."""
        return (step_keys(prng.split(key, self.m), self.local_rounds),)

    def _round_impl(self, state: PFedMeState, clients, draws):
        idx, keep = draws[0]
        w_i = state.w.expand(clients.shape[0], -1)
        for r in range(self.local_rounds):
            theta = self.prox_solve(w_i, clients, idx[r], keep_at(keep, r))
            w_i = w_i - self.eta * self.lam * (w_i - theta)
        sb = self.server_beta
        return PFedMeState(w=(1.0 - sb) * state.w + sb * cohort_mean(w_i))

    def personalized_params(self, state: PFedMeState, rows: slice):
        clients = torch.arange(self.n_clients, device=self.device)
        idx, keep = self.batch_draws(clients, self.round_key(EVAL_SEED),
                                     split=self.n_clients)
        w = state.w.expand(self.n_clients, -1)[rows]
        return self.prox_solve(w, clients[rows], idx[rows],
                               keep_at(keep, rows))

    def _lazy_personalized_rows(self, state: PFedMeState):
        """The Moreau-envelope personalization of every store slot, slot
        s under ``split(PRNGKey(99), capacity)[s]``."""
        cap = self.store.capacity
        slots = torch.arange(cap, device=self.device)
        idx, keep = self.batch_draws(slots, self.round_key(EVAL_SEED),
                                     split=cap)
        w = state.w.expand(cap, -1)
        return torch.cat([self.prox_solve(w[r], slots[r], idx[r],
                                          keep_at(keep, r))
                          for r in _chunks(cap)])

    def global_params(self, state: PFedMeState):
        return state.w
