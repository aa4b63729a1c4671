"""FedAvg (McMahan et al. 2017), the paper's non-personalized benchmark
(port of ``repro/baselines/fedavg.py``). On the lazy plane (``data`` a
``ClientDataFactory``) the cohort's rows come from the bounded store,
indexed by slot; FedAvg keeps no per-client state, so the store holds
only data."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import prng
from ..fl.base import CohortTrainer, reject_unported, step_keys


class FedAvgState(NamedTuple):
    w: torch.Tensor   # (P,) global model


class FedAvgTrainer(CohortTrainer):
    name = "fedavg"

    def __init__(self, model, data, *, lr: float = 0.05,
                 local_steps: int = 10, clients_per_round: int = 10,
                 batch_size: int = 20, device=None, scenario=None,
                 seed: int = 0, telemetry=None, store_capacity: int = 4096,
                 prefetch: bool = False, **unported):
        reject_unported(unported)
        super().__init__(model, data, batch_size, device=device,
                         scenario=scenario, seed=seed, telemetry=telemetry,
                         store_capacity=store_capacity, prefetch=prefetch)
        self.lr = lr
        self.local_steps = local_steps
        self.m = int(min(clients_per_round, self.n_clients))

    def init_state(self, seed: int = 0, params: torch.Tensor | None = None
                   ) -> FedAvgState:
        if self.store is not None:
            self._reset_store()
        return FedAvgState(w=self.initial_params(seed, params))

    def round_keys(self, key):
        """Client c's step t: ``split(split(key, m)[c], steps)[t]``."""
        return (step_keys(prng.split(key, self.m), self.local_steps),)

    def _round_impl(self, state: FedAvgState, clients, draws):
        """Local SGD on every cohort client, then the average weighted by
        the clients' training-set sizes."""
        locals_ = self.local_sgd(state.w, clients, self.lr, *draws[0])
        weights = self.data.n_train[clients].to(torch.float32)
        weights = weights / torch.sum(weights)
        return FedAvgState(w=torch.sum(weights[:, None] * locals_, dim=0))

    def global_params(self, state: FedAvgState):
        return state.w
