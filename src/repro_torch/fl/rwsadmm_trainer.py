"""RWSADMM federated trainer (paper Algorithm 1 + Eq. 31 multi-client zone).

Port of ``repro/fl/rwsadmm_trainer.py`` for the dense client plane, the
``static_regen`` environment (``core.graph.DynamicGraph``) and the degree
walk. Host side per round k:

  1. advance the dynamic graph (regenerated every ``regen_every`` rounds),
  2. the mobile server random-walks to client i_k  (Markov chain, Eq. 2),
  3. the active zone S(i_k) ⊆ N(i_k) is formed (up to ``zone_size``),
  4. one zone round on the device: stochastic gradients at the active
     clients' x'_j, closed-form (or prox-SGD) x/z updates, the masked
     incremental y update,
  5. κ ← 0.99 κ.

Zones are padded to ``zone_size`` with a mask; padded slots fold zero.

Client x and z are flat ``(n, P)`` buffers (``core/tree.py``) that each
round updates **in place**: the zone's new rows are scattered back with
``index_add_`` of ``m·(new − old)``. A state passed to :meth:`round` or
:meth:`run_chunk` is therefore consumed; clone it to keep it.

Engines:

* **eager** — :meth:`round`: plans one round on the host and syncs once
  for its metrics.
* **scan** / **scan_fused** — :meth:`schedule` precomputes a window of
  rounds (walk, zones, seeds) and :meth:`run_chunk` runs it as a Python
  loop with no host sync inside: losses and κ stay on the device until
  the window ends. ``scan_fused`` sends the closed-form update through
  the hand-written CUDA zone kernel (``kernels/rwsadmm_update``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import markov, rwsadmm
from ..core.graph import DynamicGraph
from ..core.markov import RandomWalkServer, ZoneSchedule
from ..core.rwsadmm import ClientState, RWSADMMHparams, ServerState
from ..kernels.rwsadmm_update import ops as fused_ops
from .base import DeviceData, TrainerBase

SCAN_ENGINES = ("scan", "scan_fused")
ENGINES = ("eager",) + SCAN_ENGINES
SOLVERS = ("prox_sgd", "closed_form")


class RWSADMMState(NamedTuple):
    clients: ClientState      # x, z: (n, P), updated in place
    server: ServerState
    visited: torch.Tensor     # (n,) bool — who holds a personalized model


class RWSADMMTrainer(TrainerBase):
    name = "rwsadmm"

    def __init__(
        self,
        model,
        data: DeviceData,
        hp: RWSADMMHparams = RWSADMMHparams(),
        *,
        batch_size: int = 20,
        zone_size: int = 8,
        min_degree: int = 5,
        regen_every: int = 10,
        warm_init: bool = True,
        solver: str = "prox_sgd",   # "prox_sgd" (Eq. 9, K steps) |
                                    # "closed_form" (Eq. 10/11, one step)
        inner_steps: int = 10,
        inner_lr: float = 0.05,
        seed: int = 0,
        device=None,
    ):
        super().__init__(model, data, batch_size, device=device)
        if solver not in SOLVERS:
            raise ValueError(f"solver must be one of {SOLVERS}, got {solver}")
        self.hp = hp
        self.solver = solver
        self.inner_steps = int(inner_steps)
        self.inner_lr = float(inner_lr)
        self.zone_size = int(min(zone_size, self.n_clients))
        self.warm_init = warm_init
        # static_regen: the graph stream is seeded with ``seed`` and the
        # walker with ``seed + 1``, as the reference's scenario=None.
        self.dyn_graph = DynamicGraph(self.n_clients, min_degree,
                                      regen_every, seed=seed)
        self.walker = RandomWalkServer(seed=seed + 1)
        self.walker.reset(self.dyn_graph.current())
        # Per-client service clock for the staleness metrics.
        self._last_served = np.full(self.n_clients, -1, dtype=np.int64)

    def _staleness_metrics(self, idx, mask, rnd: int) -> dict:
        """Update the per-client service clock with one round's zone and
        report rounds since last service (never served: rnd + 1)."""
        served = np.asarray(idx)[np.asarray(mask) > 0]
        self._last_served[served] = rnd
        stale = rnd - self._last_served
        return {"staleness_p50": float(np.median(stale)),
                "staleness_max": int(stale.max())}

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0, params: torch.Tensor | None = None
                   ) -> RWSADMMState:
        """Fresh state. ``params`` (flat ``(P,)``) overrides the model init
        drawn from a CPU generator seeded with ``seed``."""
        params = self.initial_params(seed, params)
        if self.warm_init:
            clients, server = rwsadmm.init_states_warm(params, self.hp,
                                                       self.n_clients)
        else:
            clients, server = rwsadmm.init_states(params, self.hp,
                                                  self.n_clients)
        visited = torch.zeros(self.n_clients, dtype=torch.bool,
                              device=self.device)
        return RWSADMMState(clients=clients, server=server, visited=visited)

    # ------------------------------------------------------------------
    def _round_impl(self, state: RWSADMMState, zone_idx: torch.Tensor,
                    zone_mask: torch.Tensor, seed: int, *,
                    use_fused: bool = False, batch_idx=None, keep=None):
        """One zone round on the device. ``zone_idx`` ``(Z,)`` int64 and
        ``zone_mask`` ``(Z,)`` fp32 device tensors; ``seed`` seeds the
        round's sampler unless ``batch_idx`` (``(Z, B)``, or
        ``(inner_steps, Z, B)`` for prox-SGD) is given, with ``keep``
        (the CNN's dropout masks, or None). Updates
        ``state``'s client buffers in place; returns the new state and
        the zone's mean training loss as a 0-d device tensor."""
        clients, server = state.clients, state.server
        hp, kappa, y = self.hp, server.kappa, server.y
        act = ClientState(x=clients.x[zone_idx], z=clients.z[zone_idx])
        steps = None if self.solver == "closed_form" else self.inner_steps
        if batch_idx is None:
            batch_idx, keep = self.zone_batch_indices(zone_idx, seed, steps)
        n_total = float(self.n_clients)
        m = zone_mask.reshape(-1, 1)

        if self.solver == "closed_form":
            losses, grads = self.zone_loss_and_grad(act.x, zone_idx,
                                                    batch_idx, keep)
            if use_fused:
                # Whole zone round (Eq. 31) in one pass over memory.
                x_new, z_new, y_new = fused_ops.zone_fused_update(
                    act.x, act.z, y, grads, zone_mask, kappa,
                    beta=hp.beta, eps_half=hp.eps_half, n_total=n_total)
            else:
                new, c_new, c_old = rwsadmm.client_round(act, y, grads, hp,
                                                         kappa)
                x_new, z_new = new
        else:
            # Iterative solver of the x-subproblem (Eq. 9): K stochastic
            # subgradient steps, warm-started at the client's stored x'.
            x_new = act.x
            for k in range(self.inner_steps):
                losses, gf = self.zone_loss_and_grad(
                    x_new, zone_idx, batch_idx[k],
                    None if keep is None else tuple(t[k] for t in keep))
                g = rwsadmm.subproblem_grad(x_new, y, act.z, gf, hp)
                x_new = x_new - self.inner_lr * g
            z_new = rwsadmm.z_update(x_new, y, act.z, hp, kappa)
            c_old = rwsadmm.contribution(act.x, act.z, y, hp)
            c_new = rwsadmm.contribution(x_new, z_new, y, hp)

        if not use_fused:
            # Masked incremental y-update: y += (1/n) Σ_active (c⁺ − c).
            y_new = y + torch.sum(m * (c_new - c_old), dim=0) / n_total

        # Scatter the active deltas back in place (zone ids are unique;
        # padded slots add m·Δ = ±0.0 to client 0's row, as the reference).
        clients.x.index_add_(0, zone_idx, m * (x_new - act.x))
        clients.z.index_add_(0, zone_idx, m * (z_new - act.z))
        server = rwsadmm.server_round_done(server, y_new, hp)
        # Padding repeats id 0, so mark by summing the mask per client
        # (order-free) rather than by a racy scatter of booleans.
        served = torch.zeros(self.n_clients, device=self.device)
        visited = state.visited | (served.index_add_(0, zone_idx,
                                                     zone_mask) > 0)
        zone_loss = torch.sum(losses * zone_mask) / torch.clamp(
            zone_mask.sum(), min=1.0)
        return RWSADMMState(clients, server, visited), zone_loss

    # ------------------------------------------------------------------
    def round(self, state: RWSADMMState, rnd: int, rng: np.random.Generator):
        """Eager engine: plan one round on the host, run it, sync once."""
        graph = self.dyn_graph.step() if rnd > 0 else self.dyn_graph.current()
        i_k = self.walker.step(graph) if rnd > 0 else self.walker.position
        idx, mask, n_i = markov.plan_zone_round(graph, int(i_k),
                                                self.zone_size, rng)
        n_active = int(mask.sum())
        seed = markov.round_key_seed(rng)
        state, zone_loss = self._round_impl(
            state, torch.as_tensor(idx, dtype=torch.int64,
                                   device=self.device),
            torch.as_tensor(mask, device=self.device), seed)
        metrics = {
            "round": rnd,
            "client": int(i_k),
            "zone": n_active,
            "n_i": int(n_i),
            "train_loss": float(zone_loss),
            "kappa": float(state.server.kappa),
            "comm_bytes": self.comm_bytes_per_round(n_active),
            **self._staleness_metrics(idx, mask, rnd),
        }
        return state, metrics

    # ------------------------------------------------------------------
    def schedule(self, rounds: int, rng: np.random.Generator,
                 *, start_round: int = 0) -> ZoneSchedule:
        """Precompute the next ``rounds`` zone rounds, consuming the
        graph/walker/sim RNGs exactly as the eager engine would."""
        return markov.zone_schedule(self.dyn_graph, self.walker, rounds,
                                    self.zone_size, rng,
                                    start_round=start_round)

    def _engine_use_fused(self, engine: str) -> bool:
        if engine not in SCAN_ENGINES:
            raise ValueError(f"engine must be one of "
                             f"{'|'.join(SCAN_ENGINES)}, got {engine}")
        use_fused = engine == "scan_fused"
        if use_fused and self.solver != "closed_form":
            raise ValueError(
                "scan_fused fuses the closed-form triple update; use "
                "solver='closed_form' (prox_sgd has no closed-form x step)")
        return use_fused

    def run_chunk(self, state: RWSADMMState, sched: ZoneSchedule,
                  engine: str = "scan"):
        """Run a schedule window with no host sync inside. Returns
        ``(state, {"train_loss": (R,), "kappa": (R,)})`` as device
        tensors."""
        use_fused = self._engine_use_fused(engine)
        idx = torch.as_tensor(sched.idx, dtype=torch.int64,
                              device=self.device)
        mask = torch.as_tensor(sched.mask, device=self.device)
        losses, kappas = [], []
        for r in range(sched.rounds):
            state, loss = self._round_impl(state, idx[r], mask[r],
                                           int(sched.keys[r]),
                                           use_fused=use_fused)
            losses.append(loss)
            kappas.append(state.server.kappa)
        return state, {"train_loss": torch.stack(losses),
                       "kappa": torch.stack(kappas)}

    def chunk_round_metrics(self, sched: ZoneSchedule, stacked: dict,
                            start_round: int) -> list[dict]:
        """Per-round metric dicts of a finished window — the same schema
        :meth:`round` emits (one device→host copy per window)."""
        losses = stacked["train_loss"].cpu().numpy()
        kappas = stacked["kappa"].cpu().numpy()
        out = []
        for j in range(sched.rounds):
            n_active = int(sched.active[j])
            entry = {
                "round": start_round + j,
                "client": int(sched.clients[j]),
                "zone": n_active,
                "n_i": int(sched.n_i[j]),
                "train_loss": float(losses[j]),
                "kappa": float(kappas[j]),
                "comm_bytes": self.comm_bytes_per_round(n_active),
            }
            entry.update(self._staleness_metrics(
                sched.idx[j], sched.mask[j], start_round + j))
            out.append(entry)
        return out

    # ------------------------------------------------------------------
    def personalized_params(self, state: RWSADMMState, rows: slice = slice(None)):
        """x_i for visited clients; unvisited clients fall back to the
        server token y (what the mobile server would hand them)."""
        v = state.visited[rows].unsqueeze(-1)
        return torch.where(v, state.clients.x[rows], state.server.y)

    def global_params(self, state: RWSADMMState):
        return state.server.y

    def comm_bytes_per_round(self, participants: int) -> int:
        # y is broadcast once into the zone; each active client uploads
        # its contribution delta — O(1) in n, the paper's claim.
        return int((1 + participants) * self.params_bytes())
