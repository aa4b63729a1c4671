"""Walkman trainer: random-walk *consensus* ADMM (paper [35] ablation;
port of ``repro/baselines/walkman_trainer.py``).

The same mobile-server random walk as RWSADMM (any scenario, degree
walk), but one client a round and a consensus update instead of
the paper's hard-inequality proximity, which isolates the personalization
mechanism. Client x and z are ``(n, P)`` buffers whose visited row each
round overwrites in place; a state passed to :meth:`round` is consumed.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import markov, walkman
from ..fl.base import TrainerBase, reject_unported


class WalkmanState(NamedTuple):
    clients: walkman.WalkmanClientState   # x, z: (n, P)
    y: torch.Tensor                       # (P,)
    round: torch.Tensor                   # 0-d int32


class WalkmanTrainer(TrainerBase):
    name = "walkman"
    #: keeps dense per-client (n, P) state, so refuses a data factory
    lazy_capable = False

    def __init__(self, model, data, *, beta: float = 3.0,
                 min_degree: int = 5, regen_every: int = 10,
                 batch_size: int = 20, scenario=None, seed: int = 0,
                 device=None, telemetry=None, mesh=None, **unported):
        reject_unported(unported)
        super().__init__(model, data, batch_size, device=device,
                         telemetry=telemetry,
                         mesh=mesh)
        self.beta = beta
        self._seed = int(seed)
        self._min_degree = int(min_degree)
        self._regen_every = int(regen_every)
        self.attach_scenario(scenario, seed=seed)

    def attach_scenario(self, spec, seed: int | None = None) -> None:
        """Walkman walks the same environment as RWSADMM: the scenario
        (mobility + link dropouts) drives its graph, seeded with
        ``seed``, and the walker with ``seed + 1``."""
        self._seed = self._seed if seed is None else int(seed)
        self._attach_walking_scenario(spec, self._seed,
                                      min_degree=self._min_degree,
                                      regen_every=self._regen_every)

    def init_state(self, seed: int = 0, params: torch.Tensor | None = None
                   ) -> WalkmanState:
        """Warm start x_i = y = init, z = 0."""
        params = self.initial_params(seed, params)
        clients, server = walkman.init_states(params, self.n_clients,
                                              warm=True)
        return WalkmanState(clients=clients, y=params, round=server.round)

    def _round_impl(self, state: WalkmanState, client: torch.Tensor, idx,
                    keep=None):
        """Client ``client`` (``(1,)``) takes one gradient step at the
        token y on its batch ``idx`` ``(1, B)``. Returns the new state
        and the loss as a 0-d device tensor."""
        x, z = state.clients
        active = walkman.WalkmanClientState(x[client], z[client])
        # Walkman's gradient-type update linearizes at the token y
        # (Walkman-B in [35]).
        losses, g = self.zone_loss_and_grad(state.y.unsqueeze(0), client,
                                            idx, keep)
        new, c_new, c_old = walkman.client_round(active, state.y, g,
                                                 self.beta)
        y = walkman.y_update(state.y, c_new[0], c_old[0], self.n_clients)
        x[client], z[client] = new.x, new.z
        return WalkmanState(state.clients, y, state.round + 1), losses[0]

    def round(self, state: WalkmanState, rnd: int, rng: np.random.Generator):
        graph = self.dyn_graph.step() if rnd > 0 else self.dyn_graph.current()
        i_k = self.walker.step(graph) if rnd > 0 else self.walker.position
        key = self.round_key(markov.round_key_seed(rng))
        client = torch.tensor([i_k], device=self.device)
        # One key for the batch and for dropout, as the reference.
        state, loss = self._round_impl(state, client,
                                       *self.batch_draws(client, key[None]))
        # The token changes hands with the one client the server stands
        # at: a near-field hand-off, not a radio hop, so the wireless
        # ledger prices it at zero (comm_bytes still counts the bytes).
        return state, {"round": rnd, "client": int(i_k),
                       "train_loss": float(loss),
                       "comm_bytes": self.comm_bytes_per_round(1),
                       "latency_s": 0.0, "energy_j": 0.0}

    def global_params(self, state: WalkmanState):
        return state.y
