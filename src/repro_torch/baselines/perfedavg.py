"""Per-FedAvg (Fallah et al. 2020), the first-order MAML variant (port of
``repro/baselines/perfedavg.py``).

Each local step: w⁺ = w − α∇f(w; ξ₁);  w ← w − β∇f(w⁺; ξ₂).
Personalized evaluation adapts the global model with one α-step on the
client's own data, on batches from a fixed seed (the Per-FedAvg
deployment protocol). On the lazy plane (``data`` a
``ClientDataFactory``) the cohort's rows come from the bounded store, and
the evaluation adapts on every resident slot, its keys slot-indexed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import prng
from ..fl.base import EVAL_CHUNK, CohortTrainer, cohort_mean, keep_at, \
    reject_unported, step_keys

#: the seed of the evaluation's key, ``PRNGKey(1234)`` as in the
#: reference
EVAL_SEED = 1234


def _chunks(n: int):
    """Row slices of ``EVAL_CHUNK`` (bounding activation memory)."""
    return [slice(c, min(c + EVAL_CHUNK, n))
            for c in range(0, n, EVAL_CHUNK)]


class PerFedAvgState(NamedTuple):
    w: torch.Tensor   # (P,)


class PerFedAvgTrainer(CohortTrainer):
    name = "perfedavg"

    def __init__(self, model, data, *, alpha: float = 0.03,
                 beta: float = 0.05, local_steps: int = 10,
                 clients_per_round: int = 10,
                 batch_size: int = 20, device=None, scenario=None,
                 seed: int = 0, telemetry=None, store_capacity: int = 4096,
                 prefetch: bool = False, **unported):
        reject_unported(unported)
        super().__init__(model, data, batch_size, device=device,
                         scenario=scenario, seed=seed, telemetry=telemetry,
                         store_capacity=store_capacity, prefetch=prefetch)
        self.alpha, self.beta = alpha, beta
        self.local_steps = local_steps
        self.m = int(min(clients_per_round, self.n_clients))

    def init_state(self, seed: int = 0, params: torch.Tensor | None = None
                   ) -> PerFedAvgState:
        if self.store is not None:
            self._reset_store()
        return PerFedAvgState(w=self.initial_params(seed, params))

    def round_keys(self, key):
        """Two keys a step, ``k1, k2 = split(k_t)`` with k_t client c's
        ``split(split(key, m)[c], steps)[t]``: block 2t is ξ₁ of step t,
        2t + 1 its ξ₂."""
        keys = prng.split(step_keys(prng.split(key, self.m),
                                    self.local_steps), 2)   # (T, m, 2, 2)
        return (keys.transpose(1, 2).reshape(-1, self.m, 2),)

    def _round_impl(self, state: PerFedAvgState, clients, draws):
        idx, keep = draws[0]
        p = state.w.expand(clients.shape[0], -1)
        for t in range(self.local_steps):
            _, g1 = self.zone_loss_and_grad(p, clients, idx[2 * t],
                                            keep_at(keep, 2 * t))
            p_in = p - self.alpha * g1
            _, g2 = self.zone_loss_and_grad(p_in, clients, idx[2 * t + 1],
                                            keep_at(keep, 2 * t + 1))
            p = p - self.beta * g2
        return PerFedAvgState(w=cohort_mean(p))

    def adapt(self, w: torch.Tensor, clients, idx, keep=None):
        """One α-step of the global model on each client's batch ``idx``
        ``(m, B)``: the personalized models ``(m, P)``."""
        _, g = self.zone_loss_and_grad(w.expand(clients.shape[0], -1),
                                       clients, idx, keep)
        return w - self.alpha * g

    def personalized_params(self, state: PerFedAvgState, rows: slice):
        clients = torch.arange(self.n_clients, device=self.device)
        idx, keep = self.batch_draws(clients, self.round_key(EVAL_SEED),
                                     split=self.n_clients)
        return self.adapt(state.w, clients[rows], idx[rows],
                          keep_at(keep, rows))

    def _lazy_personalized_rows(self, state: PerFedAvgState):
        """The deployment protocol on every store slot, slot s under
        ``split(PRNGKey(1234), capacity)[s]`` (the dense evaluation's
        sampling over the resident set)."""
        cap = self.store.capacity
        slots = torch.arange(cap, device=self.device)
        idx, keep = self.batch_draws(slots, self.round_key(EVAL_SEED),
                                     split=cap)
        return torch.cat([self.adapt(state.w, slots[r], idx[r],
                                     keep_at(keep, r))
                          for r in _chunks(cap)])

    def global_params(self, state: PerFedAvgState):
        return state.w
