"""RWSADMM federated trainer (paper Algorithm 1 + Eq. 31 multi-client zone).

Port of ``repro/fl/rwsadmm_trainer.py`` on both client planes (dense
``(n, P)`` stacks, or the lazy plane's bounded LRU store, indexed by slot),
under every walk policy (``core/markov.py``: the degree and Metropolis chains,
and the importance-biased ``staleness`` and ``label_skew`` walks), in any
scenario (``scenarios/``; ``scenario=None`` is ``static_regen``, the
``core.graph.DynamicGraph`` trajectory). Host side per round k:

  1. advance the environment (mobility, link dropouts, churn),
  2. the mobile server random-walks to client i_k  (Markov chain, Eq. 2),
  3. the active zone S(i_k) ⊆ N(i_k) is formed from the available
     clients (up to ``zone_size``) and priced (``latency_s``,
     ``energy_j``),
  4. one zone round on the device: stochastic gradients at the active
     clients' x'_j, closed-form (or prox-SGD) x/z updates, the masked
     incremental y update (under a biased policy scaled by the visit's
     importance weight iw = 1/(n·π_{i_k})),
  5. κ ← 0.99 κ.

Zones are padded to ``zone_size`` with a mask; padded slots fold zero.
A scenario changes only which slots are live, never a shape, so every
scenario runs the same captured windows.

Client x and z are flat ``(n, P)`` buffers (``core/tree.py``; on the lazy
plane ``(capacity, P)``, the store's slots) that each round updates **in
place**: the zone's new rows are scattered back with
``index_add_`` of ``m·(new − old)``. A state passed to :meth:`round` or
:meth:`run_chunk` is therefore consumed; clone it to keep it.

Engines:

* **eager** — :meth:`round`: plans one round on the host and syncs once
  for its metrics.
* **scan** / **scan_fused** — :meth:`schedule` precomputes a window of
  rounds (walk, zones, round keys) and :meth:`run_chunk` runs it with no
  host sync inside: losses and κ stay on the device until the window
  ends. ``scan_fused`` sends the closed-form update through the
  hand-written CUDA zone kernel (``kernels/rwsadmm_update``).

Every draw of a round comes from its threefry key as the reference's
(``core/prng.py``): slot j's batch and dropout masks from
``split(key, Z)[j]``. The keys are device tensors, so on a CUDA device
:meth:`run_chunk` runs a window as one CUDA graph, the counterpart of the
reference's ``lax.scan`` under ``jit``: captured once per (engine, window
length, fleet mode, whether the window carries ``iw``) and replayed after
that. The graph's state is the
trainer's carry (static x, z, y, κ, round counter, visited and the
fleet's tokens): a state handed in that is not the carry is copied into
it first, and the state returned *is* the carry. The window's inputs
(zones, masks, keys and, under a biased policy, the importance weights)
are static device buffers, each filled from pinned host memory with one
copy per window. On the CPU the window is a loop.

The lazy plane (``data`` a ``ClientDataFactory``, ``store_capacity``
slots): before a window runs, the store makes the window's whole visited
set resident, writing restored and fresh rows into the carry's x/z and its
own data block in place; the window's ``idx`` column then holds store
slots, and a ``gid`` column the global ids for ``visited``. With
``prefetch`` the next window's dataset rows are drawn on a host thread
while this one runs. ``dp_clip``/``dp_noise`` clip and noise each upload
before it reaches the token (``core/privacy.py``), on ``eager`` and
``scan``; ``scan_fused`` refuses them, as the reference does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import markov, privacy, prng, rwsadmm
from ..core.markov import ZoneSchedule
from ..core.rwsadmm import ClientState, RWSADMMHparams, ServerState
from ..data import partition
from ..kernels.rwsadmm_update import ops as fused_ops
from ..kernels.threefry import ops as threefry_ops
from .base import EVAL_CHUNK, DeviceData, TrainerBase, reject_unported

SCAN_ENGINES = ("scan", "scan_fused")
ENGINES = ("eager",) + SCAN_ENGINES
SOLVERS = ("prox_sgd", "closed_form")


class RWSADMMState(NamedTuple):
    clients: ClientState      # x, z: (n, P), updated in place
    server: ServerState
    visited: torch.Tensor     # (n,) bool — who holds a personalized model


#: the kernel wrappers a round can launch, whose counts a capture tallies
COUNTED = {"zone_update": fused_ops.zone_fused_update,
           "multizone_update": fused_ops.multizone_fused_update,
           "threefry_bits": threefry_ops.threefry_bits,
           "threefry_draws": threefry_ops.threefry_draws}


def _counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def _leaves(tree) -> list:
    """The tensors of a state, in field order (nested NamedTuples)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for field in tree for leaf in _leaves(field)]


def _rebuild(tree, leaves):
    """``tree`` with its tensors replaced, in :func:`_leaves` order."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    return type(tree)(*(_rebuild(field, leaves) for field in tree))


def _copy_into(dst, src) -> None:
    for a, b in zip(_leaves(dst), _leaves(src)):
        if a is not b:
            a.copy_(b)


class CapturedWindow:
    """One scan window as a CUDA graph: static input buffers, filled from
    pinned host memory once per window, and the graph's output losses and
    κ. ``warmup`` and ``captured`` count the kernel wrappers' calls of the
    warm-up round and of the capture (a replay runs the captured launches
    again; the wrappers' counts do not see it); ``replays`` counts the
    replays."""

    def __init__(self, cols: dict, device):
        self.inputs = {k: torch.empty(v.shape, device=device,
                                      dtype=torch.as_tensor(v[:0]).dtype)
                       for k, v in cols.items()}
        self.pinned = {k: torch.empty(v.shape, pin_memory=True,
                                      dtype=t.dtype)
                       for (k, v), t in zip(cols.items(),
                                            self.inputs.values())}
        self.copied = torch.cuda.Event()
        self.graph = torch.cuda.CUDAGraph()
        self.losses = self.kappas = None
        self.warmup: dict = {}
        self.captured: dict = {}
        self.replays = 0

    def load(self, cols: dict) -> None:
        """Copy a window's columns in: host → pinned → device, one
        asynchronous copy per input, after the last window's copies have
        read the pinned buffers."""
        self.copied.synchronize()
        for k, v in cols.items():
            self.pinned[k].numpy()[...] = v
            self.inputs[k].copy_(self.pinned[k], non_blocking=True)
        self.copied.record()


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
        scenario=None,              # a preset name or ScenarioConfig
        transition: str = "degree",       # "degree" | "metropolis"
        walk_policy: str | None = None,   # markov.WALK_POLICIES; None →
                                          # the unbiased ``transition``
        walk_bias: float = 1.0,           # staleness exponent / label-
                                          # skew sharpening γ
        batched_walk: bool = False,       # inverse-CDF walk in schedule()
                                          # (another stream than eager's)
        dp_clip: float | None = None,     # l2 clip on uploaded Δc (DP)
        dp_noise: float = 1.0,            # Gaussian noise multiplier σ
        store_capacity: int = 4096,       # lazy plane: resident slots
        prefetch: bool = False,           # lazy plane: stage the next
                                          # window's data on a host thread
        telemetry=None,                   # TelemetryRun or None (off)
        seed: int = 0,
        device=None,
        mesh=None,                        # DeviceMesh / FLSharding:
                                          # client rows over "data"
        **unported,
    ):
        reject_unported(unported)
        super().__init__(model, data, batch_size, device=device,
                         telemetry=telemetry, store_capacity=store_capacity,
                         prefetch=prefetch, mesh=mesh)
        if solver not in SOLVERS:
            raise ValueError(f"solver must be one of {SOLVERS}, got {solver}")
        self.hp = hp
        self.solver = solver
        self.dp_clip = dp_clip
        self.dp_noise = dp_noise
        self.inner_steps = int(inner_steps)
        self.inner_lr = float(inner_lr)
        self.zone_size = int(min(zone_size, self.n_clients))
        self.warm_init = warm_init
        self._seed = int(seed)
        self._min_degree = int(min_degree)
        self._regen_every = int(regen_every)
        self._transition = transition
        self.walk_policy = walk_policy
        self.walk_bias = float(walk_bias)
        self.batched_walk = bool(batched_walk)
        # Biased policies scale the y fold by each round's importance
        # weight; the uniform ones run the unweighted round unchanged.
        self._use_iw = walk_policy in markov.BIASED_POLICIES
        self._label_weights = self._label_skew_weights()
        # The environment: mobility + links + churn behind the
        # DynamicGraph contract, seeded with ``seed`` and the walker with
        # ``seed + 1``. A named or explicit ScenarioConfig is
        # authoritative: its mobility knobs win over min_degree and
        # regen_every.
        self.attach_scenario(scenario, seed=seed)
        # CUDA graphs: one per (engine, window length, fleet mode), all on
        # one carry, captured and replayed on one side stream.
        self.windows: dict[tuple, CapturedWindow] = {}
        self._carry = None
        self._stream = None
        self._chunk_shapes: set = set()   # window keys run so far

    def attach_scenario(self, spec, seed: int | None = None) -> None:
        """(Re)build the environment and reset the walker onto it;
        ``seed`` (when given) becomes the trainer's seed, so every
        derived stream (scenario layers, walker) reseeds with it."""
        self._seed = self._seed if seed is None else int(seed)
        self._attach_walking_scenario(
            spec, self._seed, min_degree=self._min_degree,
            regen_every=self._regen_every, transition=self._transition,
            walk_policy=self.walk_policy, walk_bias=self.walk_bias,
            label_weights=self._label_weights)
        # Per-client service clock for the staleness metrics.
        self._last_served = np.full(self.n_clients, -1, dtype=np.int64)

    def _label_skew_weights(self) -> np.ndarray | None:
        """Per-client utilities of the ``label_skew`` policy from the
        device label arrays, copied to the host once (None for the other
        policies)."""
        if self.walk_policy != "label_skew":
            return None
        if self.store is not None:
            raise ValueError(
                "walk_policy='label_skew' needs the per-client label "
                "histograms of the dense client plane; the lazy plane "
                "never materializes them")
        hist = partition.padded_label_histograms(
            self.whole_rows(self.data.y_train).cpu().numpy(),
            self.data.n_train.cpu().numpy())
        return partition.label_skew_weights(hist, gamma=self.walk_bias)

    def _price(self, graph, i_k, idx, mask):
        return self.scenario.price_round(graph, int(i_k), idx, mask,
                                         self.params_bytes())

    def _price_schedule(self, graphs, clients, idx, mask):
        return self.scenario.price_schedule(graphs, clients, idx, mask,
                                            self.params_bytes())

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
        the reference draws from ``PRNGKey(seed)``."""
        params = self.initial_params(seed, params)
        if self.store is not None:
            clients, server = self._init_lazy(params)
        elif self.warm_init:
            clients, server = rwsadmm.init_states_warm(params, self.hp,
                                                       self.n_clients)
        else:
            clients, server = rwsadmm.init_states(params, self.hp,
                                                  self.n_clients)
        if self.store is None and self.fl_sharding is not None:
            clients = self.fl_sharding.shard_rows(clients)
        visited = torch.zeros(self.n_clients, dtype=torch.bool,
                              device=self.device)
        return RWSADMMState(clients=clients, server=server, visited=visited)

    def _init_lazy(self, params: torch.Tensor):
        """The packed-store twin of the dense init: every client's dense
        init row is the same (warm: x = params, z = 0; cold: x = z = 0),
        so the store fills every slot from that one template, and lazy
        materialization is dense init bit for bit. ``visited`` stays a
        dense ``(n,)`` bool (n bytes, not the O(n·P) the store removes)."""
        zeros = torch.zeros_like(params)
        x = params if self.warm_init else zeros
        return (self.store.reset(ClientState(x=x, z=zeros)),
                rwsadmm._server(x.clone(), self.hp))

    def _state_clients(self, state: RWSADMMState) -> ClientState:
        return state.clients

    # ------------------------------------------------------------------
    def _round_impl(self, state: RWSADMMState, zone_idx: torch.Tensor,
                    zone_mask: torch.Tensor, key: torch.Tensor, iw=None,
                    gid=None, *, use_fused: bool = False, batch_idx=None,
                    keep=None):
        """One zone round on the device. ``zone_idx`` ``(Z,)`` int64,
        ``zone_mask`` ``(Z,)`` fp32 and the round's key ``(2,)`` int64
        device tensors; the batches and masks come from ``key`` unless
        ``batch_idx`` (``(Z, B)``, or ``(inner_steps, Z, B)`` for
        prox-SGD) is given, with ``keep`` (the CNN's dropout masks, or
        None). ``iw`` (a 0-d fp32 device tensor, biased policies only)
        scales the zone's y fold. On the lazy plane ``zone_idx`` holds
        store slots and ``gid`` the zone's global ids (for ``visited``).
        Updates ``state``'s client buffers in place; returns the new state
        and the zone's mean training loss as a 0-d device tensor."""
        clients, server = state.clients, state.server
        hp, kappa, y = self.hp, server.kappa, server.y
        act = ClientState(x=self.take_rows(clients.x, zone_idx),
                          z=self.take_rows(clients.z, zone_idx))
        steps = None if self.solver == "closed_form" else self.inner_steps
        if batch_idx is None:
            batch_idx, keep = self.zone_batch_indices(zone_idx, key, steps)
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
            # Masked incremental y-update: y += (1/n) Σ_active (c⁺ − c),
            # under a biased policy scaled by the visit's importance
            # weight so the estimator stays unbiased (docs/walks.md).
            if self.dp_clip is None:
                d = c_new - c_old
            else:
                # DP uploads: each active client's Δc clipped and noised
                # before it reaches the token, slot j under
                # split(fold_in(key, 97), Z)[j].
                dkeys = prng.split(prng.fold_in(key, 97),
                                   zone_idx.shape[0])
                d = privacy.privatize_delta(
                    dkeys, c_new, c_old, self.layout, clip=self.dp_clip,
                    noise_multiplier=self.dp_noise)
            delta = torch.sum(m * d, dim=0) / n_total
            y_new = y + (delta if iw is None else iw * delta)
        elif iw is not None:
            # The kernel folded the unweighted delta; rescale it after,
            # in the reference's form (scaling inside the kernel would
            # round differently).
            y_new = y + iw * (y_new - y)

        # Scatter the active deltas back in place (zone ids are unique;
        # padded slots add m·Δ = ±0.0 to client 0's row, as the reference).
        self.add_rows_(clients.x, zone_idx, m * (x_new - act.x))
        self.add_rows_(clients.z, zone_idx, m * (z_new - act.z))
        server = rwsadmm.server_round_done(server, y_new, hp)
        # Padding repeats id 0, so mark by summing the mask per client
        # (order-free) rather than by a racy scatter of booleans.
        served = torch.zeros(self.n_clients, device=self.device)
        visited = state.visited | (served.index_add_(
            0, zone_idx if gid is None else gid, zone_mask) > 0)
        zone_loss = torch.sum(losses * zone_mask) / torch.clamp(
            zone_mask.sum(), min=1.0)
        return RWSADMMState(clients, server, visited), zone_loss

    # ------------------------------------------------------------------
    def round(self, state: RWSADMMState, rnd: int, rng: np.random.Generator):
        """Eager engine: plan one round on the host, run it, sync once."""
        graph = self.dyn_graph.step() if rnd > 0 else self.dyn_graph.current()
        i_k = self.walker.step(graph) if rnd > 0 else self.walker.position
        idx, mask, n_i = markov.plan_zone_round(
            graph, int(i_k), self.zone_size, rng,
            avail=self.scenario.availability())
        n_active = int(mask.sum())
        latency_s, energy_j = self._price(graph, i_k, idx, mask)
        key = self.round_key(markov.round_key_seed(rng))
        zone_idx, gid = self._zone_rows(state, idx)
        state, zone_loss = self._round_impl(
            state, zone_idx, torch.as_tensor(mask, device=self.device), key,
            self._visit_weight([self.walker]), gid)
        metrics = {
            "round": rnd,
            "client": int(i_k),
            "zone": n_active,
            "n_i": int(n_i),
            "train_loss": float(zone_loss),
            "kappa": float(state.server.kappa),
            "comm_bytes": self.comm_bytes_per_round(n_active),
            "latency_s": latency_s,
            "energy_j": energy_j,
            **self._staleness_metrics(idx, mask, rnd),
        }
        return state, metrics

    def _zone_rows(self, state, idx):
        """An eager round's zone as device tensors: ``(rows, gid)``, the
        rows the round indexes (client ids, or on the lazy plane the store
        slots after making the zone resident) and the global ids for
        ``visited`` (None on the dense plane, where they are the rows)."""
        ids = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        if self.store is None:
            return ids, None
        slots = self._ensure_round(state, idx)
        return torch.as_tensor(slots, device=self.device), ids

    def _visit_weight(self, walkers):
        """Eager rounds' importance weights: each walker's latest visit's
        (the float the schedule's ``iw`` column carries), rounded to fp32
        on the device, 0-d for one walker; None for an unbiased policy."""
        if not self._use_iw:
            return None
        w = torch.tensor([wk.weight_history[-1] for wk in walkers],
                         dtype=torch.float32, device=self.device)
        return w[0] if len(walkers) == 1 else w

    # ------------------------------------------------------------------
    def schedule(self, rounds: int, rng: np.random.Generator,
                 *, start_round: int = 0) -> ZoneSchedule:
        """Precompute the next ``rounds`` zone rounds, consuming the
        graph/walker/sim RNGs exactly as the eager engine would (unless
        ``batched_walk``)."""
        return markov.zone_schedule(self.dyn_graph, self.walker, rounds,
                                    self.zone_size, rng,
                                    start_round=start_round,
                                    price=self._price_schedule,
                                    batched_walk=self.batched_walk)

    def _engine_use_fused(self, engine: str) -> bool:
        if engine not in SCAN_ENGINES:
            raise ValueError(f"engine must be one of "
                             f"{'|'.join(SCAN_ENGINES)}, got {engine}")
        use_fused = engine == "scan_fused"
        if use_fused and self.solver != "closed_form":
            raise ValueError(
                "scan_fused fuses the closed-form triple update; use "
                "solver='closed_form' (prox_sgd has no closed-form x step)")
        if use_fused and self.dp_clip is not None:
            raise ValueError("scan_fused does not support DP uploads; "
                             "use engine='scan'")
        return use_fused

    def _window_key(self, engine: str, rounds: int) -> tuple:
        """A window's capture key: (engine, length, fleet mode, whether it
        carries ``iw``)."""
        return (engine, rounds, None, self._use_iw)

    def chunk_is_cold(self, engine: str, rounds: int) -> bool:
        """True when the next window of this engine and length is the
        first of its capture key (captured on a card, so its span
        includes the capture): the telemetry spans tag it
        ``includes_compile``."""
        return self._window_key(engine, rounds) not in self._chunk_shapes

    def prefetch_chunk(self, sched) -> int:
        """Hand the next window's working set to the store's staging
        thread (no-op unless ``prefetch=True``): its dataset rows are drawn
        on the host while the current window runs."""
        if self.store is None or not self.store.prefetch_enabled:
            return 0
        return self.store.prefetch(np.asarray(sched.idx).reshape(-1))

    def run_chunk(self, state: RWSADMMState, sched: ZoneSchedule,
                  engine: str = "scan"):
        """Run a schedule window with no host sync inside: one CUDA graph
        replay on a CUDA device (captured at the first window of its
        engine and length), a loop on the CPU. Returns ``(state,
        {"train_loss": (R,), "kappa": (R,)})`` as device tensors; on a
        CUDA device the state is the trainer's carry."""
        use_fused = self._engine_use_fused(engine)
        cols = self._window_columns(sched)
        if self.store is not None:
            # The window's whole visited set (padding ids included) made
            # resident before it runs; its rounds index slots, and the
            # global ids ride along for ``visited``.
            with self._phase("ensure", rounds=int(sched.rounds)):
                cols["gid"] = cols["idx"]
                cols["idx"] = self._ensure_round(state, sched.idx)
        key = self._window_key(engine, sched.rounds)
        if self.device.type != "cuda":
            ins = {k: torch.as_tensor(v, device=self.device)
                   for k, v in cols.items()}
            state, losses, kappas = self._window(state, ins, use_fused)
        else:
            state, losses, kappas = self._replay(state, cols, key,
                                                 use_fused)
        self._chunk_shapes.add(key)
        return state, {"train_loss": losses, "kappa": kappas}

    def _window_columns(self, sched: ZoneSchedule) -> dict:
        """A window's per-round device inputs, as host arrays: under a
        biased policy the importance weights too, rounded to fp32."""
        cols = {"idx": sched.idx.astype(np.int64), "mask": sched.mask,
                "keys": sched.keys}
        if self._use_iw:
            cols["iw"] = sched.iw.astype(np.float32)
        return cols

    def _window(self, state, ins: dict, use_fused: bool):
        """The window's rounds in order: ``(state, losses (R,), κ (R,))``."""
        losses, kappas = [], []
        for r in range(ins["idx"].shape[0]):
            state, loss = self._round_impl(
                state, ins["idx"][r], ins["mask"][r], ins["keys"][r],
                ins["iw"][r] if "iw" in ins else None,
                ins["gid"][r] if "gid" in ins else None,
                use_fused=use_fused)
            losses.append(loss)
            kappas.append(state.server.kappa)
        return state, torch.stack(losses), torch.stack(kappas)

    def _adopt(self, state):
        """The carry, holding ``state``: the first state becomes it (a
        view among its tensors is cloned), later ones are copied in
        unless they are it."""
        if self._carry is None:
            self._carry = _rebuild(state, iter(
                t.clone() if t._base is not None else t
                for t in _leaves(state)))
        else:
            _copy_into(self._carry, state)
        return self._carry

    def _replay(self, state, cols: dict, key: tuple, use_fused: bool):
        """Replay the window's graph on the carry, capturing it first if
        this engine and length have no graph yet."""
        with torch.cuda.device(self.device):
            carry = self._adopt(state)
            win = self.windows.get(key)
            if win is None:
                win = self._capture(carry, cols, use_fused)
                self.windows[key] = win
            else:
                win.load(cols)
            win.graph.replay()
            win.replays += 1
            return carry, win.losses.clone(), win.kappas.clone()

    def _capture(self, carry, cols: dict, use_fused: bool) -> CapturedWindow:
        """Warm one round up on a scratch copy of the carry, on the side
        stream the capture uses (cuDNN, cuBLAS and vmap set themselves up
        outside the graph), then capture the window: its rounds, and the
        copy of the final state into the carry so that replays chain.
        Raises if the capture fails."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        win = CapturedWindow(cols, self.device)
        win.load(cols)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        before = _counts()
        with torch.cuda.stream(self._stream):
            scratch = _rebuild(carry, iter(t.clone() for t in _leaves(carry)))
            self._window(scratch, {k: v[:1] for k, v in win.inputs.items()},
                         use_fused)
            del scratch
        mid = _counts()
        main.wait_stream(self._stream)
        with torch.cuda.graph(win.graph, stream=self._stream):
            final, win.losses, win.kappas = self._window(carry, win.inputs,
                                                         use_fused)
            _copy_into(carry, final)
        after = _counts()
        win.warmup = {k: mid[k] - before[k] for k in before}
        win.captured = {k: after[k] - mid[k] for k in before}
        return win

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
            if sched.latency_s is not None:
                entry["latency_s"] = float(sched.latency_s[j])
                entry["energy_j"] = float(sched.energy_j[j])
            entry.update(self._staleness_metrics(
                sched.idx[j], sched.mask[j], start_round + j))
            out.append(entry)
        return out

    # ------------------------------------------------------------------
    def personalized_params(self, state: RWSADMMState, rows: slice = slice(None)):
        """x_i for visited clients; unvisited clients fall back to the
        server token y (what the mobile server would hand them)."""
        self._refuse_lazy("personalized_params would materialize an "
                          "(n, P) stack; on the lazy plane use evaluate() "
                          "(resident-set metrics) or read trainer.store")
        base = getattr(state, "base", state)
        v = base.visited[rows].unsqueeze(-1)
        return torch.where(v, base.clients.x[self.local_rows(rows)],
                           self._eval_token(state))

    def _refuse_lazy(self, why: str) -> None:
        if self.store is not None:
            raise NotImplementedError(why)

    def _eval_token(self, state):
        """The token unvisited clients evaluate against (the fleet's is its
        rendezvous mean)."""
        return state.server.y

    def _lazy_personalized_rows(self, state) -> torch.Tensor:
        """Per-slot personalization for the resident-set evaluation, as
        :meth:`personalized_params`: a slot whose client the walk visited
        evaluates its x row, the rest the token."""
        store = self.store
        occ = store.gid_of >= 0
        base = getattr(state, "base", state)
        ids = torch.as_tensor(np.where(occ, store.gid_of, 0),
                              device=self.device)
        v = base.visited[ids] & torch.as_tensor(occ, device=self.device)
        if self.plane is not None and self.plane.sharded:
            v = v[self.plane.lo:self.plane.hi]
        return torch.where(v.unsqueeze(-1), base.clients.x,
                           self._eval_token(state))

    def global_params(self, state: RWSADMMState):
        return state.server.y

    def comm_bytes_per_round(self, participants: int) -> int:
        # y is broadcast once into the zone; each active client uploads
        # its contribution delta — O(1) in n, the paper's claim.
        return int((1 + participants) * self.params_bytes())

    # -- diagnostics -----------------------------------------------------
    @torch.no_grad()
    def lyapunov(self, state: RWSADMMState, key: torch.Tensor) -> dict:
        """L_β (Eq. 8) and the constraint residual (Eq. 7) over all n
        clients, each client's training loss taken at its x on the batch
        ``randint(key, (B,), 0, n_i)`` without dropout (the reference's
        key, shared by every client). A dense-plane diagnostic."""
        self._refuse_lazy("lyapunov iterates all n clients' data, a "
                          "dense-plane diagnostic; run it on a dense twin "
                          "at small n")
        if self.plane is not None and self.plane.sharded:
            raise NotImplementedError("lyapunov reads every client's rows "
                                      "on one rank; run it without a mesh")
        clients = torch.arange(self.n_clients, device=self.device)
        idx, _ = prng.draws(key.expand(self.n_clients, 2),
                            batch=self.batch_size, spans=self.data.n_train,
                            clients=clients)
        losses = torch.cat([
            self._loss_rows(state.clients.x[rows], clients[rows], idx[rows])
            for rows in (slice(c, c + EVAL_CHUNK)
                         for c in range(0, self.n_clients, EVAL_CHUNK))])
        l_beta = rwsadmm.augmented_lagrangian(state.server.y, state.clients,
                                              losses, self.hp)
        viol = rwsadmm.constraint_violation(state.server.y, state.clients.x,
                                            self.hp)
        return {"L_beta": float(l_beta), "violation": float(viol)}
