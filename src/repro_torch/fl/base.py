"""Shared FL trainer substrate (port of ``repro/fl/base.py``).

Client data sits on the device as padded stacks: all n clients' (the
dense plane), or the ``capacity`` rows of the bounded LRU
:class:`~.client_store.ClientStore` (the lazy plane, when ``data`` is a
:class:`~..data.loader.ClientDataFactory`), which every round indexes by
store slot instead of client id. Each round draws
minibatch indices and dropout masks from threefry keys
(``core/prng.py``) that follow the reference's key tree (one key per
zone slot or cohort client, one per local step), gathers the batches,
and takes every active client's loss and gradient at once with
``torch.func.vmap`` over ``grad(functional_call)``. Sampling is split
from the gradient step, so a caller can hand in its own indices.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, vmap

from .. import resolve_device
from ..core import prng
from ..core.markov import RandomWalkServer, round_key_seed
from ..core.tree import ParamLayout
from ..data.loader import ClientDataFactory, FederatedData
from ..models.small import SmallModel, accuracy, cross_entropy
from ..scenarios import build_scenario

# ---------------------------------------------------------------------------
# round_metrics schema: one contract for every engine.
# ---------------------------------------------------------------------------

#: keys every round_metrics entry must carry, whichever engine emitted it
REQUIRED_ROUND_KEYS = ("round", "comm_bytes")

#: canonical host-side types of the known metric keys (bool is not an int)
ROUND_METRIC_TYPES: dict[str, type] = {
    "round": int, "comm_bytes": int, "client": int, "zone": int,
    "n_i": int, "walker": int, "staleness_max": int, "train_loss": float,
    "kappa": float, "staleness_p50": float, "clients": tuple,
    "latency_s": float, "energy_j": float,
}


def normalize_round_metrics(metrics: dict, rnd: int) -> dict:
    """Copy + backfill the keys the schema requires of every entry."""
    m = dict(metrics)
    m.setdefault("round", rnd)
    m.setdefault("comm_bytes", 0)
    return m


def validate_round_metrics(entries: list[dict], *,
                           start_round: int = 0) -> frozenset:
    """Check a round_metrics list against the schema and return its key
    set: required keys present, one key set for every entry, known keys
    with their canonical host types, rounds consecutive from
    ``start_round``. Raises ``ValueError`` on the first violation."""
    if not entries:
        return frozenset()
    keys = frozenset(entries[0])
    for i, m in enumerate(entries):
        missing = [k for k in REQUIRED_ROUND_KEYS if k not in m]
        if missing:
            raise ValueError(f"entry {i} missing required keys {missing}")
        if frozenset(m) != keys:
            raise ValueError(f"entry {i} key set {sorted(m)} != entry 0 "
                             f"{sorted(keys)}")
        if m["round"] != start_round + i:
            raise ValueError(f"entry {i}: round={m['round']}, expected "
                             f"{start_round + i}")
        for k, v in m.items():
            want = ROUND_METRIC_TYPES.get(k)
            if want is None:
                continue
            if not isinstance(v, want) or (want is not bool
                                           and isinstance(v, bool)):
                raise ValueError(f"entry {i} key {k!r}: expected "
                                 f"{want.__name__}, got "
                                 f"{type(v).__name__} ({v!r})")
    return keys


class DeviceData(NamedTuple):
    """Stacked federated data on the device (leading axis = client)."""

    x_train: torch.Tensor    # (n, m_tr, *feat) fp32
    y_train: torch.Tensor    # (n, m_tr) int64
    n_train: torch.Tensor    # (n,) int64 valid counts
    x_test: torch.Tensor     # (n, m_te, *feat) fp32
    y_test: torch.Tensor     # (n, m_te) int64
    mask_test: torch.Tensor  # (n, m_te) fp32

    @property
    def n_clients(self) -> int:
        return self.x_train.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x_train.device


def to_device_data(fed: FederatedData, device=None) -> DeviceData:
    """Move a stacked :class:`FederatedData` onto ``device`` (cuda unless
    asked otherwise)."""
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

    return DeviceData(
        x_train=put(fed.x_train, torch.float32),
        y_train=put(fed.y_train, torch.int64),
        n_train=put(fed.mask_train.sum(axis=1).astype(np.int64),
                    torch.int64),
        x_test=put(fed.x_test, torch.float32),
        y_test=put(fed.y_test, torch.int64),
        mask_test=put(fed.mask_test, torch.float32),
    )


def gather_batch(data: DeviceData, clients: torch.Tensor,
                 idx: torch.Tensor):
    """Per-slot minibatches: ``clients`` ``(Z,)``, ``idx`` ``(Z, B)`` →
    ``x (Z, B, *feat)``, ``y (Z, B)``."""
    rows = clients.unsqueeze(-1)
    return data.x_train[rows, idx], data.y_train[rows, idx]


#: clients evaluated per vmapped batch (bounds activation memory)
EVAL_CHUNK = 32

#: the reference trainers' arguments the port does not take yet, and the
#: ROADMAP Queue 1 item that brings each (none left)
UNPORTED: dict[str, str] = {}


def reject_unported(kwargs: dict) -> None:
    """Raise for any argument of the reference's trainers that the port
    does not take yet, naming the ROADMAP item that brings it."""
    for name in kwargs:
        if name not in UNPORTED:
            raise TypeError(f"unexpected keyword argument {name!r}")
        raise NotImplementedError(
            f"{name}= is not ported yet (ROADMAP Queue 1 "
            f"{UNPORTED[name]})")


def keep_at(keep, t):
    """The dropout keep masks at index ``t`` of their leading axis (a
    local step, or a slice of clients), or None for a model without
    dropout."""
    return None if keep is None else tuple(k[t] for k in keep)


def step_keys(keys: torch.Tensor, steps: int) -> torch.Tensor:
    """Each row's ``split(key, steps)``, step-major: ``(m, 2)`` →
    ``(steps, m, 2)``, as a ``lax.scan`` over the split keys walks them."""
    return prng.split(keys, steps).transpose(0, 1)


def cohort_mean(rows: torch.Tensor) -> torch.Tensor:
    """Mean over the leading (cohort or walker) axis as the sum times
    1/m: how the reference's mean rounds (XLA turns its division into
    that product)."""
    return rows.sum(dim=0) * (1.0 / rows.shape[0])


class TrainerBase:
    """Common plumbing: device, flat layout, per-client gradients, eval,
    the client plane (dense stacks or the lazy store) and telemetry."""

    name: str = "base"
    #: whether this trainer runs on the lazy client plane (``data`` a
    #: ``ClientDataFactory``, clients in the bounded LRU store). Trainers
    #: that keep dense per-client ``(n, P)`` stacks in their state
    #: (Ditto, APFL, Walkman) set it False and refuse a factory.
    lazy_capable: bool = True

    def __init__(self, model: SmallModel, data, batch_size: int = 20, *,
                 device=None, telemetry=None, store_capacity: int = 4096,
                 prefetch: bool = False, mesh=None):
        self.device = resolve_device(device)
        lazy = not isinstance(data, DeviceData)
        if lazy and not self.lazy_capable:
            raise NotImplementedError(
                f"{type(self).__name__} keeps dense per-client (n, …) "
                "state stacks and does not support client_plane='lazy'; "
                "pass stacked DeviceData")
        if lazy and not isinstance(data, ClientDataFactory):
            raise TypeError(f"data must be DeviceData or a "
                            f"ClientDataFactory, got {type(data).__name__}")
        if not lazy and data.device.type != self.device.type:
            raise ValueError(f"data lives on {data.device}, trainer runs "
                             f"on {self.device}")
        self.model = model
        self.client_plane = "lazy" if lazy else "dense"
        # The sharded client plane (fl/sharding.py): with a mesh, each rank
        # holds its block of the leading client (dense) or capacity (lazy)
        # axis; ``plane`` does the rows' gathers and writes. None: every
        # row here, every op the plain one.
        self.fl_sharding = None
        self.plane = None
        if mesh is not None:
            from .sharding import FLSharding

            self.fl_sharding = (mesh if isinstance(mesh, FLSharding)
                                else FLSharding(mesh))
        self.store = None
        if lazy:
            from .client_store import ClientStore

            self.store = ClientStore(data, int(store_capacity),
                                     device=self.device, prefetch=prefetch,
                                     sharding=self.fl_sharding)
            # Rounds index the store's packed block by slot; the block is
            # allocated once and written in place, so this binding (and
            # every captured window that reads it) stays valid.
            self.data = self.store.data
            self.plane = self.store.plane
        else:
            self.data = data
            if self.fl_sharding is not None:
                self.plane = self.fl_sharding.plane(data.n_clients)
                # the (n,) counts stay whole: every rank draws the batches
                self.data = DeviceData(*(
                    col if name == "n_train" else self.plane.local(col)
                    for name, col in zip(DeviceData._fields, data)))
        self.batch_size = int(batch_size)
        self.n_clients = data.n_clients
        self.layout = ParamLayout.from_module(model)
        self.scenario = None   # attach_scenario() / the trainers' kwarg
        self.telemetry = None
        self.set_telemetry(telemetry)

        def loss(params, xb, yb, keep):
            logits = functional_call(model, params, (xb,),
                                     {"train": True, "keep": keep})
            return cross_entropy(logits, yb)

        has_dropout = bool(model.keep_probs)
        self._grad_zone = vmap(grad_and_value(loss),
                               in_dims=(0, 0, 0, 0 if has_dropout else None))
        self._loss_stacked = vmap(loss, in_dims=(0, 0, 0, None))

        def eval_row(params, x, y, m):
            logits = functional_call(model, params, (x,))
            return accuracy(logits, y, m), cross_entropy(logits, y, m)

        self._eval_stacked = vmap(eval_row, in_dims=(0, 0, 0, 0))
        self._eval_shared = vmap(eval_row, in_dims=(None, 0, 0, 0))

    # -- state, sampling + gradients ----------------------------------------
    def initial_params(self, seed: int = 0,
                       params: torch.Tensor | None = None) -> torch.Tensor:
        """Flat ``(P,)`` fp32 params on the device: ``params`` if given,
        else the reference's ``model.init(PRNGKey(seed))``, drawn on the
        CPU whatever the device (see ``SmallModel.init_params``)."""
        if params is None:
            init = self.model.init_params(prng.prng_key(seed))
            params = self.layout.flatten(init)
        return params.to(device=self.device, dtype=torch.float32)

    # -- scenario plumbing (mobility / links / churn, scenarios/) ---------
    def attach_scenario(self, spec, seed: int = 0) -> None:
        """Attach an environment scenario (a preset name or a
        ``ScenarioConfig``).

        For the infrastructure-based baselines the scenario contributes
        client churn (availability gates selection) and wireless round
        pricing against a central base station. They never read the
        connectivity graph, so the scenario runs positions-only:
        mobility advances positions (the same RNG stream) and no
        adjacency is built. Graph-walking trainers override this with
        :meth:`_attach_walking_scenario`."""
        self.scenario = build_scenario(spec, self.n_clients, seed=seed,
                                       positions_only=True)
        self.scenario.telemetry = self.telemetry

    def _attach_walking_scenario(self, spec, seed: int, *,
                                 min_degree: int = 5,
                                 regen_every: int = 10,
                                 transition: str = "degree",
                                 walk_policy: str | None = None,
                                 walk_bias: float = 1.0,
                                 label_weights=None) -> None:
        """Shared attach path of the graph-walking trainers (RWSADMM,
        Walkman, fleets): build the full scenario, expose it as the
        ``dyn_graph`` the schedules step, and reset a walker seeded with
        ``seed + 1`` on its current graph: the ``transition`` chain, or
        the walk policy ``walk_policy`` (``markov.WALK_POLICIES``) with
        bias ``walk_bias`` and, for ``label_skew``, ``label_weights``.
        ``spec=None`` is ``static_regen`` from
        ``min_degree``/``regen_every``, the ``DynamicGraph`` trajectory
        bit for bit."""
        self.scenario = build_scenario(spec, self.n_clients, seed=seed,
                                       min_degree=min_degree,
                                       regen_every=regen_every)
        self.scenario.telemetry = self.telemetry
        self.dyn_graph = self.scenario
        self.walker = RandomWalkServer(transition=transition, seed=seed + 1,
                                       policy=walk_policy,
                                       bias_gamma=float(walk_bias))
        if label_weights is not None:
            self.walker.set_label_weights(label_weights)
        self.walker.reset(self.dyn_graph.current())

    def select_clients(self, rnd: int, rng: np.random.Generator,
                       m: int) -> np.ndarray:
        """Uniform client selection, churn-aware when a scenario is
        attached. Without one this consumes ``rng`` exactly like the
        reference's ``rng.choice(n, m, replace=False)``."""
        if self.scenario is None:
            return rng.choice(self.n_clients, size=m, replace=False)
        if rnd > 0:
            self.scenario.step()
        avail = self.scenario.availability()
        pool = (np.flatnonzero(avail) if avail is not None
                else np.arange(self.n_clients))
        if len(pool) == 0:
            pool = np.arange(self.n_clients)
        # The round needs a fixed cohort size: when churn leaves fewer
        # than m clients awake, resample the pool (duplicates reweight
        # the average).
        return rng.choice(pool, size=m, replace=len(pool) < m)

    def scenario_round_costs(self, members: np.ndarray) -> dict:
        """Wireless latency/energy of one baseline round against the base
        station, or {} with no scenario attached. Every cohort slot is
        priced (duplicates from churn resampling count as transfers, as
        in ``comm_bytes_per_round``)."""
        if self.scenario is None:
            return {}
        lat, en = self.scenario.price_star_round(np.asarray(members),
                                                 self.params_bytes())
        return {"latency_s": lat, "energy_j": en}

    def round_key(self, seed: int) -> torch.Tensor:
        """The round's key, ``PRNGKey(seed)``, on the device."""
        return prng.prng_key(seed, self.device)

    def batch_draws(self, clients: torch.Tensor, keys: torch.Tensor,
                    split: int | None = None):
        """Batch indices and the CNN's dropout keep masks under ``keys``
        ``(..., m, 2)``, one key per client of ``clients`` ``(m,)`` along
        the last lead axis, in one ``threefry_draws`` launch: ``idx``
        ``(..., m, B)``, as the reference's ``randint(key, (B,), 0,
        n_train[client])``, and the masks its model draws from the same
        key (or None). With ``split`` the keys are first split
        ``split`` ways in the launch, the split leading (``step_keys``)."""
        idx, keep = prng.draws(keys, split=split, batch=self.batch_size,
                               spans=self.data.n_train, clients=clients,
                               masks=self.model.keep_masks(self.batch_size))
        return idx, (keep or None)

    def zone_batch_indices(self, clients: torch.Tensor, key: torch.Tensor,
                           steps: int | None = None):
        """:meth:`batch_draws` of a zone round's key tree: slot j's key is
        ``split(key, Z)[j]``, and with ``steps`` (prox-SGD's inner loop)
        step t's is ``split(that, steps)[t]`` (``(steps, Z, B)``). The
        last split runs inside the draws' launch."""
        if steps is None:
            return self.batch_draws(clients, key, split=clients.shape[0])
        return self.batch_draws(clients, prng.split(key, clients.shape[0]),
                                split=steps)

    # -- the client plane's rows (plain ops without a sharded plane) ------
    def take_rows(self, t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (client ids, or store slots) of a plane leaf."""
        return t[idx] if self.plane is None else self.plane.take(t, idx)

    def add_rows_(self, t: torch.Tensor, idx: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
        """``t.index_add_(0, idx, values)`` on a plane leaf."""
        if self.plane is None:
            return t.index_add_(0, idx, values)
        return self.plane.index_add_(t, idx, values)

    def local_rows(self, rows: slice) -> slice:
        """A slice of global rows of this rank's block as a slice of its
        plane leaves."""
        if self.plane is None or not self.plane.sharded:
            return rows
        return slice(rows.start - self.plane.lo, rows.stop - self.plane.lo)

    def whole_rows(self, t: torch.Tensor) -> torch.Tensor:
        """A plane leaf whole, every rank's block gathered."""
        return t if self.plane is None else self.plane.whole(t)

    def _gather_batch(self, clients: torch.Tensor, idx: torch.Tensor):
        if self.plane is None:
            return gather_batch(self.data, clients, idx)
        rows = clients.unsqueeze(-1)
        return (self.plane.take2(self.data.x_train, rows, idx),
                self.plane.take2(self.data.y_train, rows, idx))

    def zone_loss_and_grad(self, x: torch.Tensor, clients: torch.Tensor,
                           idx: torch.Tensor, keep=None):
        """Per-client training loss and gradient at the zone's rows.
        ``x``: ``(Z, P)`` flat params; returns ``(losses (Z,), g (Z, P))``."""
        xb, yb = self._gather_batch(clients, idx)
        params = self.layout.views(x)
        grads, losses = self._grad_zone(params, xb, yb, keep)
        return losses, self.layout.flatten(grads, batch_dims=1)

    def _loss_rows(self, x: torch.Tensor, clients: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
        """Each row's training loss at its params ``x`` ``(m, P)`` on the
        batch ``idx`` ``(m, B)`` of its client, without dropout."""
        xb, yb = gather_batch(self.data, clients, idx)
        return self._loss_stacked(self.layout.views(x), xb, yb, None)

    def local_sgd(self, w: torch.Tensor, clients: torch.Tensor, lr: float,
                  idx: torch.Tensor, keep=None) -> torch.Tensor:
        """Every cohort client's local SGD from ``w`` (``(P,)`` shared or
        ``(m, P)``): ``idx.shape[0]`` steps p ← p − lr·∇f(p; ξ_t) on the
        batches ``idx`` ``(T, m, B)`` with keep masks ``(T, m, …)``
        (the reference's ``make_local_sgd``, vmapped over the cohort).
        Returns ``(m, P)``; each step replaces the cohort's rows."""
        p = w.expand(clients.shape[0], -1)
        for t in range(idx.shape[0]):
            _, g = self.zone_loss_and_grad(p, clients, idx[t],
                                           keep_at(keep, t))
            p = p - lr * g
        return p

    # -- evaluation ---------------------------------------------------------
    def personalized_params(self, state, rows: slice) -> torch.Tensor | None:
        """Flat ``(rows, P)`` personalized parameters, or None."""
        return None

    def global_params(self, state) -> torch.Tensor | None:
        return None

    def _eval_rows(self, state, pers_rows):
        """Per-row test accuracy and loss of the personalized models
        (``pers_rows(rows)`` → ``(rows, P)`` or None, ``rows`` a slice of
        global rows) and the global model over the plane's rows, in chunks
        of ``EVAL_CHUNK`` to bound activation memory: ``(pers (acc, loss)
        or None, glob or None)``. On a sharded plane each rank takes its
        block's rows and the results are gathered whole."""
        d = self.data
        lo, hi = 0, d.x_test.shape[0]
        if self.plane is not None and self.plane.sharded:
            lo, hi = self.plane.lo, self.plane.hi
        pers_acc, pers_loss, glob_acc, glob_loss = [], [], [], []
        glob = self.global_params(state)
        for c0 in range(lo, hi, EVAL_CHUNK):
            rows = slice(c0, min(c0 + EVAL_CHUNK, hi))
            here = self.local_rows(rows)
            cols = (d.x_test[here], d.y_test[here], d.mask_test[here])
            pers = pers_rows(rows)
            if pers is not None:
                a, l_ = self._eval_stacked(self.layout.views(pers), *cols)
                pers_acc.append(a)
                pers_loss.append(l_)
            if glob is not None:
                a, l_ = self._eval_shared(self.layout.views(glob), *cols)
                glob_acc.append(a)
                glob_loss.append(l_)
        def cat(acc, loss):
            if not acc:
                return None
            return (self.whole_rows(torch.cat(acc)),
                    self.whole_rows(torch.cat(loss)))
        return cat(pers_acc, pers_loss), cat(glob_acc, glob_loss)

    @torch.no_grad()
    def evaluate(self, state) -> dict:
        """Mean test accuracy/loss over every client: personalized models
        (``acc_personalized`` ± ``acc_personalized_std``, population std)
        and the global token (``acc_global``). On the lazy plane over the
        resident clients only (:meth:`_evaluate_lazy`)."""
        if self.store is not None:
            return self._evaluate_lazy(state)
        pers, glob = self._eval_rows(
            state, lambda rows: self.personalized_params(state, rows))
        out: dict[str, float] = {}
        if pers is not None:
            acc, loss = pers
            out["acc_personalized"] = float(acc.mean())
            out["acc_personalized_std"] = float(acc.std(correction=0))
            out["loss_personalized"] = float(loss.mean())
        if glob is not None:
            out["acc_global"] = float(glob[0].mean())
            out["loss_global"] = float(glob[1].mean())
        out["acc"] = out.get("acc_personalized", out.get("acc_global", 0.0))
        return out

    @torch.no_grad()
    def _evaluate_lazy(self, state) -> dict:
        """Evaluation over the materialized clients, the lazy plane's
        answer to the dense path's all-n loop: every store slot is
        evaluated (fixed shapes) and the occupied ones averaged, on the
        host in numpy as the reference averages. Personalized rows come
        from :meth:`_lazy_personalized_rows` (None: the global model
        only). ``eval_clients`` says how many clients the estimate
        covers: at large n a resident-set sample of the population
        metric, by design."""
        occ = self.store.gid_of >= 0
        pers_all = self._lazy_personalized_rows(state)
        pers, glob = self._eval_rows(
            state, lambda rows: None if pers_all is None
            else pers_all[self.local_rows(rows)])

        def stats(pair):
            return tuple(t.cpu().numpy()[occ] for t in pair)

        out: dict[str, float] = {}
        if pers is not None:
            acc, loss = stats(pers)
            out["acc_personalized"] = float(acc.mean()) if len(acc) else 0.0
            out["acc_personalized_std"] = (float(acc.std())
                                           if len(acc) else 0.0)
            out["loss_personalized"] = (float(loss.mean())
                                        if len(loss) else 0.0)
        if glob is not None:
            acc, loss = stats(glob)
            out["acc_global"] = float(acc.mean()) if len(acc) else 0.0
            out["loss_global"] = float(loss.mean()) if len(loss) else 0.0
        out["acc"] = out.get("acc_personalized",
                             out.get("acc_global", 0.0))
        out["eval_clients"] = int(occ.sum())
        return out

    def _lazy_personalized_rows(self, state) -> torch.Tensor | None:
        """Per-slot ``(capacity, P)`` personalized parameters for the lazy
        evaluation, or None when the trainer evaluates the global model
        only. RWSADMM substitutes visited clients' x rows; the
        adaptation baselines adapt the global model on each slot's rows."""
        return None

    # -- the lazy client plane ---------------------------------------------
    def _state_clients(self, state) -> tuple:
        """The packed per-client state tensors of ``state`` (what the store
        restores into and evicts from); the FedAvg family keeps none, and
        the store then manages only the data block."""
        return ()

    def _reset_store(self) -> None:
        """(Re)initialize the client store for a fresh run of a trainer
        with no per-client state (the store then holds data only). Call
        from ``init_state``."""
        self.store.reset(())

    def _ensure_round(self, state, idx) -> np.ndarray:
        """Make one working set resident (its rows written into
        ``state``'s packed tensors in place) and translate global ids to
        store slots, same shape. ``idx`` is the raw padded id array:
        padding id 0 rides along, so the masked ±0.0 scatter-adds land on
        the same client's row on both planes."""
        idx = np.asarray(idx)
        stats = self.store.ensure(self._state_clients(state),
                                  idx.reshape(-1))
        self._emit_store_counters(stats)
        return self.store.slots(idx)

    def _emit_store_counters(self, stats: dict) -> None:
        """Stream one ensure's hit/miss/evict/restore (and, with prefetch,
        its pipeline) deltas into telemetry: host values only, no RNG."""
        if self.telemetry is None:
            return
        for k, v in stats.items():
            self.telemetry.counter(f"client_store_{k}", int(v))

    # -- telemetry ------------------------------------------------------------
    def set_telemetry(self, run) -> None:
        """Attach (or detach, ``None``) a ``TelemetryRun``: the trainer,
        its scenario and its store emit spans and events into it. No RNG
        stream and no device operation changes, so runs are unchanged."""
        self.telemetry = run
        if self.scenario is not None:
            self.scenario.telemetry = run
        if self.store is not None:
            self.store.telemetry = run

    def _phase(self, name: str, **meta):
        """A phase-timer span of the attached run (CUDA events on this
        trainer's device), or one that records nowhere when telemetry is
        off."""
        if self.telemetry is None:
            from ..telemetry import null_phase

            return null_phase()
        return self.telemetry.phase(name, device=self.device, **meta)

    # -- communication accounting --------------------------------------------
    def params_bytes(self) -> int:
        """Bytes of one fp32 model copy."""
        return self.layout.n_bytes(torch.float32)

    def comm_bytes_per_round(self, participants: int) -> int:
        """Default: each participant downloads + uploads one model copy."""
        return int(2 * participants * self.params_bytes())


class CohortTrainer(TrainerBase):
    """The FedAvg family's round (port of the baselines' shared
    ``round``): a cohort of ``m`` clients, then one seed for the round's
    key, both drawn from the host RNG as the reference draws them. A
    subclass sets ``m``, implements :meth:`round_keys` (its key tree)
    and :meth:`_round_impl`. ``scenario`` (a preset name or
    ``ScenarioConfig``, seeded with ``seed``) gates selection by churn
    and prices each round against the base station, as
    ``run_simulation(scenario=)`` attaches it."""

    m: int

    def __init__(self, model: SmallModel, data, batch_size: int = 20, *,
                 device=None, scenario=None, seed: int = 0, telemetry=None,
                 store_capacity: int = 4096, prefetch: bool = False,
                 mesh=None):
        super().__init__(model, data, batch_size, device=device,
                         telemetry=telemetry, store_capacity=store_capacity,
                         prefetch=prefetch, mesh=mesh)
        if scenario is not None:
            self.attach_scenario(scenario, seed=seed)

    def round_keys(self, key: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The round's key blocks ``(T, m, 2)``, one per batch block the
        round consumes, as the reference splits its round key."""
        raise NotImplementedError  # pragma: no cover

    def round_draws(self, clients: torch.Tensor, key: torch.Tensor) -> tuple:
        """One ``(idx (T, m, B), keep)`` block per key block."""
        return tuple(self.batch_draws(clients, keys)
                     for keys in self.round_keys(key))

    def _round_impl(self, state, clients: torch.Tensor, draws: tuple):
        raise NotImplementedError  # pragma: no cover

    def round(self, state, rnd: int, rng: np.random.Generator):
        sel = self.select_clients(rnd, rng, self.m)
        key = self.round_key(round_key_seed(rng))
        # Lazy plane: the cohort's rows made resident, indexed by slot.
        rows = sel if self.store is None else self._ensure_round(state, sel)
        clients = torch.as_tensor(rows, dtype=torch.int64,
                                  device=self.device)
        state = self._round_impl(state, clients,
                                 self.round_draws(clients, key))
        return state, {"round": rnd,
                       "comm_bytes": self.comm_bytes_per_round(self.m),
                       **self.scenario_round_costs(sel)}
