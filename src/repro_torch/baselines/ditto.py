"""Ditto (Li et al. 2021): global FedAvg plus a personal model v_i per
client trained with the proximal objective f_i(v) + (λ/2)||v − w||²
(port of ``repro/baselines/ditto.py``).

The personal models are one ``(n, P)`` buffer that each round updates in
place: the cohort's rows get ``v′ − v`` added, as the reference's
``.at[sel].add(new − old)`` (v + (v′ − v) is not always v′ in floating
point). A state passed to :meth:`round` is therefore consumed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import prng
from ..fl.base import CohortTrainer, cohort_mean, keep_at, reject_unported, \
    step_keys


class DittoState(NamedTuple):
    w: torch.Tensor   # (P,) global model
    v: torch.Tensor   # (n, P) personal models, updated in place


class DittoTrainer(CohortTrainer):
    name = "ditto"
    #: keeps dense per-client (n, P) state, so refuses a data factory
    lazy_capable = False

    def __init__(self, model, data, *, lam: float = 1.0, lr: float = 0.05,
                 local_steps: int = 10, personal_steps: int = 5,
                 clients_per_round: int = 10, batch_size: int = 20,
                 device=None, scenario=None, seed: int = 0, telemetry=None,
                 mesh=None, **unported):
        reject_unported(unported)
        super().__init__(model, data, batch_size, device=device,
                         scenario=scenario, seed=seed,
                         telemetry=telemetry,
                         mesh=mesh)
        self.m = int(min(clients_per_round, self.n_clients))
        self.lam, self.lr = lam, lr
        self.local_steps, self.personal_steps = local_steps, personal_steps

    def init_state(self, seed: int = 0, params: torch.Tensor | None = None
                   ) -> DittoState:
        w = self.initial_params(seed, params)
        return DittoState(w=w, v=w.repeat(self.n_clients, 1))

    def round_keys(self, key):
        """The global part's keys from ``split(key, m)``, the personal
        part's from ``split(fold_in(key, 7), m)``, each split per step."""
        m = self.m
        return (step_keys(prng.split(key, m), self.local_steps),
                step_keys(prng.split(prng.fold_in(key, 7), m),
                          self.personal_steps))

    def _round_impl(self, state: DittoState, clients, draws):
        (idx, keep), (p_idx, p_keep) = draws
        w, lr, lam = state.w, self.lr, self.lam
        w_new = cohort_mean(self.local_sgd(w, clients, lr, idx, keep))
        v_sel = state.v[clients]
        v = v_sel
        for s in range(self.personal_steps):
            _, g = self.zone_loss_and_grad(v, clients, p_idx[s],
                                           keep_at(p_keep, s))
            v = v - lr * (g + lam * (v - w))
        state.v.index_add_(0, clients, v - v_sel)
        return DittoState(w=w_new, v=state.v)

    def personalized_params(self, state: DittoState, rows: slice):
        return state.v[rows]

    def global_params(self, state: DittoState):
        return state.w
