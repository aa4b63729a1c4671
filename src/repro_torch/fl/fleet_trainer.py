"""Fleet-RWSADMM: K mobile servers over one client graph.

Port of ``repro/fl/fleet_trainer.py`` on both client planes (the lazy
plane's store slots as the single walker's), with DP uploads in
round-robin mode, under every walk policy (each walker runs the lead
walker's chain; a biased
policy scales each walker's y fold by its visit's importance weight), in
any scenario (``scenarios/``). K walkers each carry
their own token y_k and walk the same dynamic graph independently; every
``sync_every`` rounds the fleet rendezvouses and the tokens average.
Client states (x_i, z_i) are shared: a client updates against whichever
walker reaches it.

Two fleet modes:

* ``fleet_mode="roundrobin"`` (default): the walkers take turns. Round r
  is served by walker ``r % K`` against its own token through the
  single-walker round (:meth:`RWSADMMTrainer._round_impl`, the zone
  kernel on ``scan_fused``). With ``n_walkers=1`` it is the single-walker
  trajectory exactly.
* ``fleet_mode="simultaneous"``: every wall step moves all K walkers and
  serves K disjoint zones at once (lowest walker index wins a contested
  client, ``markov.plan_fleet_zone_round``). The K·Z gradients come from
  one call, and the K masked Eq. 31 updates from one launch of the
  multi-zone kernel on ``scan_fused`` (the plain
  ``rwsadmm.multizone_round_masked`` otherwise). κ decays once per wall
  step. A wall step's latency is the slowest walker's zone (the zones
  are served in parallel), its energy the sum over walkers.

The tokens are one ``(K, P)`` tensor. As in the single-walker trainer,
client buffers are updated in place: a state passed to :meth:`round` or
:meth:`run_chunk` is consumed. The active walker, the rendezvous flag and
the round key are device tensors (the walker's token is read and written
by index), so :meth:`run_chunk` never syncs and a window runs as one
CUDA graph on a CUDA device, as the single walker's does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import markov, rwsadmm
from ..core.markov import FleetZoneSchedule, RandomWalkServer
from ..core.rwsadmm import ClientState, RWSADMMHparams
from ..kernels.rwsadmm_update import ops as fused_ops
from .base import DeviceData, cohort_mean
from .rwsadmm_trainer import RWSADMMState, RWSADMMTrainer

FLEET_MODES = ("roundrobin", "simultaneous")


class FleetState(NamedTuple):
    """base: clients and server bookkeeping (κ, round, visited);
    ``base.server.y`` mirrors the last active walker's token (walker 0's
    in simultaneous mode). tokens: ``(K, P)``, one token per walker."""

    base: RWSADMMState
    tokens: torch.Tensor


def _rendezvous(tokens: torch.Tensor, sync: torch.Tensor) -> torch.Tensor:
    """Where ``sync`` > 0 every walker's token becomes the fleet mean,
    else the stack passes through. ``sync`` is a 0-d device tensor. The
    mean must round as the reference's: a last-bit difference in a token
    would flip sgn(y − x) wherever a client still holds x = y, and move
    that x by ε at its next visit."""
    return torch.where(sync > 0, cohort_mean(tokens), tokens)


class FleetRWSADMMTrainer(RWSADMMTrainer):
    name = "rwsadmm_fleet"

    def __init__(self, model, data: DeviceData,
                 hp: RWSADMMHparams = RWSADMMHparams(), *,
                 n_walkers: int = 3, sync_every: int = 20,
                 fleet_mode: str = "roundrobin", seed: int = 0, **kw):
        if fleet_mode not in FLEET_MODES:
            raise ValueError(f"fleet_mode must be one of "
                             f"{'|'.join(FLEET_MODES)}, got {fleet_mode!r}")
        if int(n_walkers) < 1:
            raise ValueError(f"n_walkers must be ≥ 1, got {n_walkers}")
        super().__init__(model, data, hp, seed=seed, **kw)
        self.n_walkers = int(n_walkers)
        self.sync_every = int(sync_every)
        self.fleet_mode = fleet_mode
        if fleet_mode == "simultaneous" and self.solver != "closed_form":
            raise ValueError("simultaneous fleet mode runs the closed-form "
                             "Eq. 31 zone update; use solver='closed_form'")
        if fleet_mode == "simultaneous" and self.dp_clip is not None:
            raise ValueError("simultaneous fleet mode does not support DP "
                             "uploads")
        self._reset_fleet()

    def _reset_fleet(self) -> None:
        """K walkers on the current graph, each on the lead walker's
        chain, policy, bias and label weights. Walker k's stream is
        seed + 1 + 10k: walker 0 replays the single-walker trainer's
        walker (seed + 1) draw for draw."""
        lead = self.walker
        self.walkers = [RandomWalkServer(transition=lead.transition,
                                         seed=self._seed + 1 + 10 * k,
                                         policy=lead.policy,
                                         bias_gamma=lead.bias_gamma)
                        for k in range(self.n_walkers)]
        for w in self.walkers:
            w.set_label_weights(lead.label_weights)
            w.reset(self.dyn_graph.current())

    def attach_scenario(self, spec, seed: int | None = None) -> None:
        """The single walker's attach, then the K walkers over the new
        environment's graph (once the fleet exists)."""
        super().attach_scenario(spec, seed=seed)
        if hasattr(self, "walkers"):
            self._reset_fleet()

    def init_state(self, seed: int = 0, params: torch.Tensor | None = None
                   ) -> FleetState:
        base = super().init_state(seed, params)
        tokens = base.server.y.unsqueeze(0).repeat(self.n_walkers, 1)
        return FleetState(base=base, tokens=tokens)

    # ------------------------------------------------------------------
    # One round of each mode; the eager and scan engines share them.
    # ------------------------------------------------------------------
    def _state_clients(self, state: FleetState):
        return state.base.clients

    def _eval_token(self, state: FleetState):
        return self.global_params(state)

    def _window_key(self, engine: str, rounds: int) -> tuple:
        return (engine, rounds, self.fleet_mode, self._use_iw)

    def _rr_step(self, state: FleetState, idx, mask, a: torch.Tensor, sync,
                 key, iw=None, gid=None, *, use_fused: bool = False,
                 batch_idx=None, keep=None):
        """Round-robin round: walker ``a`` (a 0-d int64 device tensor)
        serves one zone against its own token (its fold scaled by ``iw``
        under a biased policy), then the optional rendezvous. ``gid``:
        the zone's global ids on the lazy plane (``idx`` then slots)."""
        a = a.reshape(1)
        base = state.base._replace(server=state.base.server._replace(
            y=state.tokens.index_select(0, a)[0]))
        base, loss = self._round_impl(base, idx, mask, key, iw, gid,
                                      use_fused=use_fused,
                                      batch_idx=batch_idx, keep=keep)
        tokens = state.tokens.index_copy(0, a, base.server.y.unsqueeze(0))
        return FleetState(base, _rendezvous(tokens, sync)), loss

    def _sim_step(self, state: FleetState, idx, mask, sync, key, iw=None,
                  gid=None, *, use_fused: bool = False, batch_idx=None,
                  keep=None):
        """Simultaneous wall step: K disjoint zones (idx/mask ``(K, Z)``)
        update against their own walkers' tokens in one pass. Batch
        indices (``(K·Z, B)``) are drawn for the flattened slots from
        ``split(key, K·Z)`` unless given. ``iw`` ``(K,)`` (a biased
        policy) rescales each walker's token fold after the update.
        ``gid``: the zones' global ids on the lazy plane (``idx`` then
        slots)."""
        clients, server = state.base.clients, state.base.server
        hp = self.hp
        k_walkers, zone = idx.shape
        flat_idx, flat_mask = idx.reshape(-1), mask.reshape(-1)
        act_x = self.take_rows(clients.x, flat_idx)
        act_z = self.take_rows(clients.z, flat_idx)
        if batch_idx is None:
            batch_idx, keep = self.zone_batch_indices(flat_idx, key)
        losses, grads = self.zone_loss_and_grad(act_x, flat_idx, batch_idx,
                                                keep)
        stacked = (k_walkers, zone, -1)
        n_total = float(self.n_clients)
        if use_fused:
            # All K zones' Eq. 31 updates in one kernel launch.
            x_new, z_new, y_new = fused_ops.multizone_fused_update(
                act_x.view(stacked), act_z.view(stacked), state.tokens,
                grads.view(stacked), mask, server.kappa, beta=hp.beta,
                eps_half=hp.eps_half, n_total=n_total)
        else:
            new, y_new = rwsadmm.multizone_round_masked(
                ClientState(x=act_x.view(stacked), z=act_z.view(stacked)),
                state.tokens, grads.view(stacked), mask, hp, server.kappa,
                n_total)
            x_new, z_new = new
        if iw is not None:
            # Each walker's Walk-for-Learning correction, post hoc.
            y_new = state.tokens + iw.reshape(k_walkers, 1) * (
                y_new - state.tokens)
        # One scatter for all K zones: the planner keeps them disjoint,
        # and padding repeats id 0 with a zero delta.
        m = flat_mask.unsqueeze(-1)
        self.add_rows_(clients.x, flat_idx,
                       m * (x_new.reshape(act_x.shape) - act_x))
        self.add_rows_(clients.z, flat_idx,
                       m * (z_new.reshape(act_z.shape) - act_z))
        tokens = _rendezvous(y_new, sync)
        served = torch.zeros(self.n_clients, device=self.device)
        visited = state.base.visited | (served.index_add_(
            0, flat_idx if gid is None else gid.reshape(-1), flat_mask) > 0)
        base = RWSADMMState(clients,
                            rwsadmm.server_round_done(server, tokens[0], hp),
                            visited)
        loss = torch.sum(losses * flat_mask) / torch.clamp(flat_mask.sum(),
                                                           min=1.0)
        return FleetState(base, tokens), loss

    def _sync_flag(self, rnd: int) -> torch.Tensor:
        """0-d device rendezvous flag for round ``rnd`` (the schedule's
        rule, :func:`markov._sync_mask`)."""
        return torch.as_tensor(markov._sync_mask(rnd, 1, self.sync_every),
                               device=self.device)[0]

    # ------------------------------------------------------------------
    # Eager engine.
    # ------------------------------------------------------------------
    def round(self, state: FleetState, rnd: int, rng: np.random.Generator):
        """Eager engine: plan one round (one wall step in simultaneous
        mode) on the host, run it, sync once for its metrics."""
        if self.fleet_mode == "simultaneous":
            return self._round_simultaneous(state, rnd, rng)
        k = rnd % self.n_walkers
        parked = rnd < self.n_walkers
        graph = self.dyn_graph.current() if parked else self.dyn_graph.step()
        walker = self.walkers[k]
        i_k = walker.position if parked else walker.step(graph)
        idx, mask, n_i = markov.plan_zone_round(
            graph, int(i_k), self.zone_size, rng,
            avail=self.scenario.availability())
        n_active = int(mask.sum())
        latency_s, energy_j = self._price(graph, i_k, idx, mask)
        key = self.round_key(markov.round_key_seed(rng))
        zone_idx, gid = self._zone_rows(state, idx)
        state, loss = self._rr_step(
            state, zone_idx, torch.as_tensor(mask, device=self.device),
            torch.tensor(k, device=self.device), self._sync_flag(rnd), key,
            self._visit_weight([walker]), gid)
        metrics = {
            "round": rnd, "walker": k, "client": int(i_k),
            "zone": n_active, "n_i": int(n_i),
            "train_loss": float(loss),
            "kappa": float(state.base.server.kappa),
            "comm_bytes": self.comm_bytes_per_round(n_active),
            "latency_s": latency_s,
            "energy_j": energy_j,
            **self._staleness_metrics(idx, mask, rnd),
        }
        return state, metrics

    def _round_simultaneous(self, state: FleetState, rnd: int,
                            rng: np.random.Generator):
        graph = self.dyn_graph.step() if rnd > 0 else self.dyn_graph.current()
        positions = np.array([w.step(graph) if rnd > 0 else w.position
                              for w in self.walkers])
        idx, mask, n_i = markov.plan_fleet_zone_round(
            graph, positions, self.zone_size, rng,
            avail=self.scenario.availability())
        key = self.round_key(markov.round_key_seed(rng))
        zone_idx, gid = self._zone_rows(state, idx)
        state, loss = self._sim_step(
            state, zone_idx, torch.as_tensor(mask, device=self.device),
            self._sync_flag(rnd), key, self._visit_weight(self.walkers),
            gid)
        lat_kw, en_kw = self._price_fleet_schedule(
            [graph], positions[None], idx[None], mask[None])
        active = mask.sum(axis=1).astype(int)
        metrics = {
            "round": rnd,
            "clients": tuple(int(c) for c in positions),
            "zone": int(active.sum()), "n_i": int(n_i.sum()),
            "train_loss": float(loss),
            "kappa": float(state.base.server.kappa),
            "comm_bytes": self._fleet_comm_bytes(active),
            "latency_s": float(lat_kw.max()),
            "energy_j": float(en_kw.sum()),
            **self._staleness_metrics(idx, mask, rnd),
        }
        return state, metrics

    def _fleet_comm_bytes(self, active) -> int:
        # Idle walkers (all-padding zones) transmit nothing.
        return int(sum(self.comm_bytes_per_round(int(a))
                       for a in active if a))

    # ------------------------------------------------------------------
    # Scan engines.
    # ------------------------------------------------------------------
    def _price_fleet_schedule(self, graphs, clients, idx, mask):
        """Per-walker prices of a simultaneous window: (R, K) columns."""
        return self.scenario.price_fleet_schedule(graphs, clients, idx, mask,
                                                  self.params_bytes())

    def schedule(self, rounds: int, rng: np.random.Generator,
                 *, start_round: int = 0) -> FleetZoneSchedule:
        """Precompute ``rounds`` fleet rounds, consuming the graph, walker
        and simulation RNGs exactly as the eager fleet would."""
        return markov.fleet_zone_schedule(
            self.dyn_graph, self.walkers, rounds, self.zone_size, rng,
            start_round=start_round, sync_every=self.sync_every,
            mode=self.fleet_mode, price=self._price_schedule,
            price_fleet=self._price_fleet_schedule,
            batched_walk=self.batched_walk)

    def _window_columns(self, sched: FleetZoneSchedule) -> dict:
        cols = super()._window_columns(sched)
        cols["sync"] = sched.sync
        if sched.mode == "roundrobin":
            cols["walker"] = sched.walker.astype(np.int64)
        return cols

    def _window(self, state: FleetState, ins: dict, use_fused: bool):
        losses, kappas = [], []
        for r in range(ins["idx"].shape[0]):
            idx, mask, sync, key = (ins[k][r] for k in ("idx", "mask",
                                                        "sync", "keys"))
            iw = ins["iw"][r] if "iw" in ins else None
            gid = ins["gid"][r] if "gid" in ins else None
            if "walker" in ins:
                state, loss = self._rr_step(state, idx, mask,
                                            ins["walker"][r], sync, key, iw,
                                            gid, use_fused=use_fused)
            else:
                state, loss = self._sim_step(state, idx, mask, sync, key,
                                             iw, gid, use_fused=use_fused)
            losses.append(loss)
            kappas.append(state.base.server.kappa)
        return state, torch.stack(losses), torch.stack(kappas)

    def chunk_round_metrics(self, sched: FleetZoneSchedule, stacked: dict,
                            start_round: int) -> list[dict]:
        """Per-round metric dicts of a finished window, the schema
        :meth:`round` emits."""
        if sched.mode == "roundrobin":
            entries = super().chunk_round_metrics(sched, stacked,
                                                  start_round)
            for j, entry in enumerate(entries):
                entry["walker"] = int(sched.walker[j])
            return entries
        losses = stacked["train_loss"].cpu().numpy()
        kappas = stacked["kappa"].cpu().numpy()
        out = []
        for j in range(sched.rounds):
            entry = {
                "round": start_round + j,
                "clients": tuple(int(c) for c in sched.clients[j]),
                "zone": int(sched.active[j].sum()),
                "n_i": int(sched.n_i[j].sum()),
                "train_loss": float(losses[j]),
                "kappa": float(kappas[j]),
                "comm_bytes": self._fleet_comm_bytes(sched.active[j]),
            }
            if sched.latency_s is not None:
                entry["latency_s"] = float(sched.latency_s[j])
                entry["energy_j"] = float(sched.energy_j[j])
            entry.update(self._staleness_metrics(
                sched.idx[j], sched.mask[j], start_round + j))
            out.append(entry)
        return out

    # ------------------------------------------------------------------
    # personalized_params (inherited): unvisited clients fall back to the
    # fleet-mean token (what a rendezvous would hand them).
    def global_params(self, state: FleetState):
        return cohort_mean(state.tokens)

    def fleet_hitting_time(self) -> int | None:
        """Wall-clock steps until the union of the walkers' visits covers
        every client (the K vehicles move at once, so one wall step is
        one move of every walker), or None."""
        seen: set[int] = set()
        hists = [w.history for w in self.walkers]
        for step in range(max(len(h) for h in hists)):
            for h in hists:
                if step < len(h):
                    seen.add(h[step])
            if len(seen) == self.n_clients:
                return step
        return None
