"""APFL (Deng et al. 2020), adaptive personalized FL (port of
``repro/baselines/apfl.py``).

Each client keeps a local model v_i and mixing weight α; the served model
is v̄_i = α v_i + (1−α) w. Local steps update the global copy w_i with
∇f(w_i) and v_i with α·∇f(v̄_i) on the same batch; the server averages
w_i. The ``(n, P)`` buffer of v_i is updated in place by adding the
cohort's ``v′ − v``, as in Ditto; a state passed to :meth:`round` is
consumed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import prng
from ..fl.base import CohortTrainer, cohort_mean, keep_at, reject_unported, \
    step_keys


class APFLState(NamedTuple):
    w: torch.Tensor   # (P,)
    v: torch.Tensor   # (n, P), updated in place


class APFLTrainer(CohortTrainer):
    name = "apfl"
    #: keeps dense per-client (n, P) state, so refuses a data factory
    lazy_capable = False

    def __init__(self, model, data, *, alpha: float = 0.5, lr: float = 0.05,
                 local_steps: int = 10, clients_per_round: int = 10,
                 batch_size: int = 20, device=None, scenario=None,
                 seed: int = 0, telemetry=None, **unported):
        reject_unported(unported)
        super().__init__(model, data, batch_size, device=device,
                         scenario=scenario, seed=seed,
                         telemetry=telemetry)
        self.m = int(min(clients_per_round, self.n_clients))
        self.alpha, self.lr = alpha, lr
        self.local_steps = local_steps

    def init_state(self, seed: int = 0, params: torch.Tensor | None = None
                   ) -> APFLState:
        w = self.initial_params(seed, params)
        return APFLState(w=w, v=w.repeat(self.n_clients, 1))

    def round_keys(self, key):
        """Client c's step t: ``split(split(key, m)[c], steps)[t]``, one
        batch for both of the step's gradients."""
        return (step_keys(prng.split(key, self.m), self.local_steps),)

    def _round_impl(self, state: APFLState, clients, draws):
        idx, keep = draws[0]
        alpha, lr = self.alpha, self.lr
        v_sel = state.v[clients]
        w_i, v_i = state.w.expand(clients.shape[0], -1), v_sel
        for t in range(self.local_steps):
            k = keep_at(keep, t)
            _, gw = self.zone_loss_and_grad(w_i, clients, idx[t], k)
            w_i = w_i - lr * gw
            mixed = alpha * v_i + (1 - alpha) * w_i
            _, gv = self.zone_loss_and_grad(mixed, clients, idx[t], k)
            v_i = v_i - lr * alpha * gv
        state.v.index_add_(0, clients, v_i - v_sel)
        return APFLState(w=cohort_mean(w_i), v=state.v)

    def personalized_params(self, state: APFLState, rows: slice):
        return self.alpha * state.v[rows] + (1 - self.alpha) * state.w

    def global_params(self, state: APFLState):
        return state.w
