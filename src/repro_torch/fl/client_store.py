"""Bounded LRU client-state store, the lazy client plane's core (port of
``repro/fl/client_store.py``).

RWSADMM's mobile server only touches the clients it walks to: over R
rounds the walker activates O(R·Z) ≪ n clients, yet the dense plane holds
x/z and a dataset for all n from the start. This store keeps packed
``(capacity, P)`` x/z rows and a packed :class:`~.base.DeviceData` block
of ``capacity`` rows on the device, keyed by an id → slot map:

* a first visit **materializes** a client: its x/z rows come from the
  shared init template (the dense init is the same for every client, so
  lazy init ≡ dense init bit for bit), its data rows from a deterministic
  :class:`~..data.loader.ClientDataFactory`;
* a cold client is **evicted** to a host spill buffer (x/z rows only,
  the exact fp32 bits; its data is drawn anew from the factory on a
  revisit, the same bytes because the factory is pure);
* a revisit **restores** the spilled rows into a free slot.

The packed x/z rows belong to the trainer's state, which the store
writes **in place** (``index_copy_`` on the current stream); the data
block belongs to the store and is allocated once, so a captured CUDA
graph that reads either keeps valid addresses. The id → slot map, the LRU
order and the spill buffer stay on the host in numpy. Host rows reach the
device through pinned buffers that are rewritten only after the previous
call's copies from them have landed (an event, as
``CapturedWindow.load``); an eviction reads its victims back after an
event recorded behind the device work queued before it, not a device-wide
sync.

Schedules pad zones with client id 0 (mask 0), and the round still
gathers id 0's row and scatter-adds a masked ±0.0 into it, so the padding
id must be resident too: callers pass the raw padded id arrays to
:meth:`ClientStore.ensure`, never ones filtered by the mask.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..data.loader import ClientDataFactory
from .base import DeviceData

#: keys of the stats dict every ensure() call returns (all deltas)
STORE_COUNTERS = ("hits", "misses", "evictions", "restores")

#: extra stats keys when the prefetch pipeline is on (``prefetch=True``):
#: of one ensure()'s misses, how many the staging buffer served (hits)
#: and how many were drawn then (misses). Emitted as
#: ``client_store_prefetch_{hits,misses}`` telemetry counters, only with
#: prefetch on, so the default event stream is unchanged.
PREFETCH_COUNTERS = ("prefetch_hits", "prefetch_misses")

#: the data block's columns (``DeviceData`` order) and their dtypes
_DATA_DTYPES = (torch.float32, torch.int64, torch.int64, torch.float32,
                torch.int64, torch.float32)


def _dedupe_keep_order(ids: np.ndarray) -> np.ndarray:
    """Unique ids in first-appearance order: the store's visit order for
    a batched ensure (LRU recency follows it)."""
    ids = np.asarray(ids).reshape(-1).astype(np.int64)
    _, first = np.unique(ids, return_index=True)
    return ids[np.sort(first)]


def _like(template, leaves):
    """``leaves`` in ``template``'s container (a NamedTuple or tuple)."""
    leaves = tuple(leaves)
    return type(template)(*leaves) if hasattr(template, "_fields") \
        else leaves


class _Uploads:
    """Host rows → device through one pinned buffer per column. A call
    set runs between :meth:`begin` (wait until the last set's copies have
    read their buffers) and :meth:`end` (record that the copies were
    issued). On the CPU the rows are used as they are."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.pinned: dict[str, torch.Tensor] = {}
        self.copied = torch.cuda.Event() if self.cuda else None

    def begin(self) -> None:
        if self.cuda:
            self.copied.synchronize()

    def put(self, name: str, rows: np.ndarray,
            dtype: torch.dtype) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(rows)).to(dtype)
        if not self.cuda:
            return host
        buf = self.pinned.get(name)
        if buf is None or buf.numel() < host.numel():
            buf = torch.empty(max(host.numel(), 1), dtype=dtype,
                              pin_memory=True)
            self.pinned[name] = buf
        staged = buf[:host.numel()].view(host.shape)
        staged.copy_(host)
        return staged.to(self.device, non_blocking=True)

    def end(self) -> None:
        if self.cuda:
            self.copied.record(torch.cuda.current_stream(self.device))


class ClientStore:
    """Bounded LRU store of per-client ADMM state and dataset rows.

    Parameters
    ----------
    factory: per-client dataset source (``rows(ids)`` in ``DeviceData``
        column order). Its ``n_clients`` bounds the id space.
    capacity: resident slots. One :meth:`ensure` call's working set may
        not exceed it (a scan window ensures its whole visited set at
        once: size capacity ≥ the window's R·Z bound, plus the padding
        id).
    device: where the packed rows live.
    prefetch: the staging pipeline: :meth:`prefetch` draws a predicted
        working set's dataset rows on a host thread (numpy only) while the
        device runs; the next :meth:`ensure` joins the thread and takes
        the staged rows. The factory is pure, so prefetch on ≡ off bit
        for bit.
    """

    def __init__(self, factory: ClientDataFactory, capacity: int, *,
                 device: torch.device, prefetch: bool = False):
        self.factory = factory
        self.capacity = int(capacity)
        self.n_clients = int(factory.n_clients)
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.device = device
        self.prefetch_enabled = bool(prefetch)
        self.telemetry = None   # set by the owning trainer
        self._template: tuple | None = None
        self._uploads = _Uploads(device)
        # The packed data block, allocated once: captured windows read it
        # by address, so reset() and ensure() write it in place.
        f, cap = factory, self.capacity
        feat = tuple(f.feature_shape)
        shapes = ((cap, f.max_train) + feat, (cap, f.max_train), (cap,),
                  (cap, f.max_test) + feat, (cap, f.max_test),
                  (cap, f.max_test))
        self.data = DeviceData(*(torch.zeros(s, dtype=d, device=device)
                                 for s, d in zip(shapes, _DATA_DTYPES)))
        # id → slot (-1 = not resident), slot → id (-1 = free)
        self.slot_arr = np.full(self.n_clients, -1, dtype=np.int64)
        self.gid_of = np.full(self.capacity, -1, dtype=np.int64)
        self._lru: OrderedDict[int, None] = OrderedDict()
        self._free: list[int] = list(range(self.capacity - 1, -1, -1))
        self._spill: dict[int, list[np.ndarray]] = {}
        # id → staged dataset rows (one entry per DeviceData column),
        # written only by the prefetch worker, read and consumed only
        # after _join_prefetch().
        self._staging: dict[int, list[np.ndarray]] = {}
        self._inflight: threading.Thread | None = None
        self._worker_error: BaseException | None = None
        self.counters = {k: 0 for k in self._counter_keys()}
        self.evicted_bytes = self.restored_bytes = 0

    def _counter_keys(self) -> tuple:
        """Counters this store keeps: the prefetch pipeline's exist only
        with the pipeline, so a store without it keeps the four."""
        return STORE_COUNTERS + (PREFETCH_COUNTERS
                                 if self.prefetch_enabled else ())

    # ------------------------------------------------------------- init --
    def reset(self, template):
        """(Re)initialize for a fresh run: remember the single-client init
        rows ``template`` (a NamedTuple or tuple of ``(P,)`` tensors, every
        client's dense init; empty for a trainer with no per-client
        state), clear the map, LRU order, spill and counters, zero the
        data block in place, and return the packed ``(capacity, P)``
        state with every slot filled from the template."""
        self._join_prefetch()
        self._template = _like(template, (t.detach().clone()
                                          for t in template))
        self.slot_arr[:] = -1
        self.gid_of[:] = -1
        self._lru.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
        self._spill.clear()
        self._staging.clear()
        self.counters = {k: 0 for k in self._counter_keys()}
        self.evicted_bytes = self.restored_bytes = 0
        for col in self.data:
            col.zero_()
        self.data.n_train.fill_(1)
        return _like(template, (t.expand(self.capacity, -1).clone()
                                for t in self._template))

    # ------------------------------------------------------ introspection --
    @property
    def resident_ids(self) -> np.ndarray:
        """Resident client ids, least- to most-recently visited."""
        return np.fromiter(self._lru.keys(), dtype=np.int64,
                           count=len(self._lru))

    @property
    def n_resident(self) -> int:
        return len(self._lru)

    @property
    def spilled_ids(self) -> np.ndarray:
        return np.array(sorted(self._spill), dtype=np.int64)

    def slots(self, ids) -> np.ndarray:
        """Global client ids → resident slots (any shape, int64). Every id
        must be resident (``ensure`` first)."""
        ids = np.asarray(ids)
        slots = self.slot_arr[ids]
        if (slots < 0).any():
            missing = np.unique(ids[slots < 0])
            raise KeyError(f"clients not resident: {missing.tolist()[:10]}")
        return slots

    # ------------------------------------------------------------ ensure --
    def ensure(self, clients, ids) -> dict:
        """Make every id in ``ids`` resident, writing restored and fresh
        rows into the packed state ``clients`` (the trainer's ``(capacity,
        P)`` tensors) and the data block in place; returns this call's
        counter deltas.

        ``ids`` is deduplicated in first-appearance order, which becomes
        the LRU touch order (visit order ⇒ eviction order). Misses take
        free slots first, then evict the least recently visited residents
        *outside the current working set*, whose x/z rows are read back
        to the host spill buffer before the slot is reused."""
        if self._template is None:
            raise RuntimeError("ClientStore.reset(template) must run "
                               "before ensure(): call init_state first")
        # Any in-flight prefetch staging lands before this call reads or
        # consumes the staging buffer.
        self._join_prefetch()
        ids = _dedupe_keep_order(ids)
        if len(ids) > self.capacity:
            raise ValueError(
                f"working set of {len(ids)} clients exceeds store "
                f"capacity {self.capacity}; raise store_capacity or "
                f"shorten the scan window (eval_every)")
        if len(ids) and (ids.min() < 0 or ids.max() >= self.n_clients):
            raise IndexError(f"client id out of range [0, "
                             f"{self.n_clients}): {ids.min()},{ids.max()}")
        stats = {k: 0 for k in STORE_COUNTERS}
        missing = ids[self.slot_arr[ids] < 0]
        stats["hits"] = len(ids) - len(missing)
        stats["misses"] = len(missing)
        if self.prefetch_enabled:
            staged = sum(1 for i in missing if int(i) in self._staging)
            stats["prefetch_hits"] = staged
            stats["prefetch_misses"] = len(missing) - staged
        if len(missing):
            need = len(missing) - len(self._free)
            if need > 0:
                working = set(ids.tolist())
                victims = [i for i in self._lru if i not in working][:need]
                self._evict(clients, np.array(victims, dtype=np.int64))
                stats["evictions"] = need
            slots = np.array([self._free.pop() for _ in missing],
                             dtype=np.int64)
            for i, s in zip(missing, slots):
                self.slot_arr[i] = s
                self.gid_of[s] = i
                self._lru[int(i)] = None
            restored = np.array([int(i) in self._spill for i in missing])
            self._uploads.begin()
            self._write_state_rows(clients, missing, slots, restored)
            self._write_data_rows(missing, slots)
            self._uploads.end()
            stats["restores"] = int(restored.sum())
        # Touch in visit order, so recency follows ``ids``.
        for i in ids:
            self._lru.move_to_end(int(i))
        for k, v in stats.items():
            self.counters[k] += v
        return stats

    # ---------------------------------------------------------- prefetch --
    def prefetch(self, ids) -> int:
        """Stage a predicted working set's dataset rows on a host thread:
        the ids in ``ids`` neither resident nor staged get their factory
        rows drawn off the critical path, so the next :meth:`ensure`
        (which joins the thread first) serves them as ``prefetch_hits``.

        Returns the number of ids handed to the worker; a no-op unless the
        store was built with ``prefetch=True``. The worker touches only
        the factory (numpy) and the staging dict: never the map, the LRU
        order, the spill buffer or a tensor, so the device's work runs
        undisturbed and the run is bit for bit the one without prefetch.
        """
        if not self.prefetch_enabled:
            return 0
        self._join_prefetch()          # at most one worker in flight
        ids = _dedupe_keep_order(ids)
        todo = np.array([int(i) for i in ids
                         if self.slot_arr[i] < 0
                         and int(i) not in self._staging], dtype=np.int64)
        if len(todo) == 0:
            return 0
        telemetry = self.telemetry

        def stage():
            cols = self.factory.rows(todo)
            for k, i in enumerate(todo):
                self._staging[int(i)] = [c[k] for c in cols]

        def work():
            try:
                if telemetry is None:
                    stage()
                else:
                    # The span's t0/seconds place the staging on the run's
                    # timeline, beside the scan_chunk span it overlaps.
                    with telemetry.phase("prefetch_stage", ids=len(todo)):
                        stage()
            except BaseException as e:   # re-raised by the next join
                self._worker_error = e

        self._inflight = threading.Thread(
            target=work, name="client-store-prefetch", daemon=True)
        self._inflight.start()
        return len(todo)

    def _join_prefetch(self) -> None:
        """Wait for the staging thread; a failure in it raises here."""
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise RuntimeError("client-store prefetch failed") from err

    # ----------------------------------------------------------- internals --
    def _read_rows(self, clients, slots: np.ndarray) -> list[np.ndarray]:
        """The packed rows at ``slots`` on the host, exact bits: gathered
        on the current stream, copied into pinned memory, read after an
        event recorded behind them."""
        idx = torch.as_tensor(slots, device=self.device)
        rows = [leaf.index_select(0, idx) for leaf in clients]
        if self.device.type != "cuda":
            return [r.numpy() for r in rows]
        host = [torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
                for r in rows]
        for h, r in zip(host, rows):
            h.copy_(r, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        done.synchronize()
        return [h.numpy() for h in host]

    def _evict(self, clients, victims: np.ndarray) -> None:
        vslots = self.slot_arr[victims]
        leaves = self._read_rows(clients, vslots) if len(clients) else []
        for j, i in enumerate(victims):
            self._spill[int(i)] = [leaf[j].copy() for leaf in leaves]
            self.evicted_bytes += sum(leaf[j].nbytes for leaf in leaves)
            del self._lru[int(i)]
            self.slot_arr[i] = -1
        for s in vslots:
            self.gid_of[s] = -1
            self._free.append(int(s))

    def _write_state_rows(self, clients, ids: np.ndarray, slots: np.ndarray,
                          restored: np.ndarray) -> None:
        if not len(clients):
            for i in ids[restored]:
                del self._spill[int(i)]
            return
        fresh = slots[~restored]
        if len(fresh):
            idx = torch.as_tensor(fresh, device=self.device)
            for leaf, row in zip(clients, self._template):
                leaf.index_copy_(0, idx, row.expand(len(fresh), -1))
        sp_ids = ids[restored]
        if len(sp_ids):
            idx = torch.as_tensor(slots[restored], device=self.device)
            for j, leaf in enumerate(clients):
                rows = np.stack([self._spill[int(i)][j] for i in sp_ids])
                self.restored_bytes += rows.nbytes
                leaf.index_copy_(0, idx, self._uploads.put(
                    f"state{j}", rows, leaf.dtype))
            for i in sp_ids:
                del self._spill[int(i)]

    def _write_data_rows(self, ids: np.ndarray, slots: np.ndarray) -> None:
        rows = self._materialize_rows(ids)
        idx = torch.as_tensor(slots, device=self.device)
        for j, (col, r) in enumerate(zip(self.data, rows)):
            col.index_copy_(0, idx, self._uploads.put(f"data{j}", r,
                                                      col.dtype))

    def _materialize_rows(self, ids: np.ndarray):
        """Dataset rows for ``ids`` in order: from the staging buffer
        where staged (consumed), from the factory otherwise. The factory
        is pure, so either path gives the same bytes."""
        staged = np.array([int(i) in self._staging for i in ids],
                          dtype=bool)
        if not staged.any():
            return self.factory.rows(ids)
        fresh_ids = ids[~staged]
        fresh = (self.factory.rows(fresh_ids) if len(fresh_ids)
                 else None)
        out = []
        for j in range(len(DeviceData._fields)):
            fi = iter(range(len(fresh_ids)))
            out.append(np.stack([
                self._staging[int(i)][j] if staged[k]
                else np.asarray(fresh[j])[next(fi)]
                for k, i in enumerate(ids)]))
        for i in ids[staged]:
            del self._staging[int(i)]
        return tuple(out)

    # -------------------------------------------------------- checkpointing --
    def state_dict(self) -> dict[str, np.ndarray]:
        """Host arrays of the map, the LRU order, the spill buffer and the
        counters (the packed x/z rows are part of the trainer's state and
        saved with it). Spilled rows ride along stacked per leaf;
        ``checkpoint.save_client_store`` writes this to npz."""
        d: dict[str, np.ndarray] = {
            "gid_of": self.gid_of.copy(),
            "lru": self.resident_ids,
            "counters": np.array([self.counters[k] for k in STORE_COUNTERS],
                                 dtype=np.int64),
            "spill_ids": self.spilled_ids,
        }
        if len(self._spill):
            n_leaves = len(next(iter(self._spill.values())))
            for j in range(n_leaves):
                d[f"spill_leaf_{j}"] = np.stack(
                    [self._spill[int(i)][j] for i in d["spill_ids"]])
        return d

    def load_state_dict(self, d: dict) -> None:
        """Restore the map, LRU order, spill buffer and counters, and
        write the resident clients' data rows anew from the factory (data
        is never spilled: the factory gives the same bytes)."""
        if self._template is None:
            raise RuntimeError("reset(template) before load_state_dict "
                               "(build the store via init_state first)")
        gid_of = np.asarray(d["gid_of"], dtype=np.int64)
        if gid_of.shape != (self.capacity,):
            raise ValueError(
                f"checkpoint capacity {gid_of.shape[0]} != store "
                f"capacity {self.capacity}")
        self._join_prefetch()
        self._staging.clear()
        self.gid_of = gid_of.copy()
        self.slot_arr[:] = -1
        occupied = np.flatnonzero(gid_of >= 0)
        self.slot_arr[gid_of[occupied]] = occupied
        self._free = [int(s) for s in range(self.capacity - 1, -1, -1)
                      if gid_of[s] < 0]
        self._lru = OrderedDict((int(i), None)
                                for i in np.asarray(d["lru"]))
        # The core counters only: the prefetch counters describe this
        # process's pipeline and restart at zero.
        cnt = np.asarray(d["counters"])
        self.counters = {k: 0 for k in self._counter_keys()}
        self.counters.update(
            {k: int(cnt[j]) for j, k in enumerate(STORE_COUNTERS)})
        keys = sorted((k for k in d if k.startswith("spill_leaf_")),
                      key=lambda s: int(s.rsplit("_", 1)[1]))
        self._spill = {int(i): [np.asarray(d[k][j]) for k in keys]
                       for j, i in enumerate(np.asarray(d["spill_ids"],
                                                        dtype=np.int64))}
        if len(occupied):
            self._uploads.begin()
            self._write_data_rows(gid_of[occupied], occupied)
            self._uploads.end()
