"""The port's bounded LRU client store (``repro_torch.fl.client_store``)
against its properties and against the reference's ``ClientStore``.

Each property of ``tests/test_client_store.py`` holds here on the port's
store (a hypothesis property with a deterministic seed sweep beside it):
residency and LRU bookkeeping follow an independent python oracle, evict
→ restore is bit-exact, visit order is eviction order, a store as large
as the visited set never evicts, a working set over capacity raises, the
prefetch pipeline is invisible to the LRU and its counters follow a
staging-set oracle. Then the port's store and the reference's are driven
through the same id sequences: slot map, LRU order, counters and spilled
ids agree by ``==``, and the data rows byte for byte.
"""
import os
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import pytest
import torch

from _hypothesis_compat import HAVE_HYPOTHESIS, hypothesis, st
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.checkpoint import load_client_store, save_client_store
from repro_torch.data import synthetic_lr_factory
from repro_torch.fl.client_store import (
    PREFETCH_COUNTERS,
    STORE_COUNTERS,
    ClientStore,
)

if HAVE_HYPOTHESIS:
    hypothesis.settings.register_profile(
        "smoke", max_examples=20, deadline=None,
        suppress_health_check=[hypothesis.HealthCheck.too_slow])
    hypothesis.settings.register_profile("default", deadline=None)
    hypothesis.settings.load_profile(
        os.environ.get("HYPOTHESIS_PROFILE", "default"))

N_CLIENTS = 12
CPU = torch.device("cpu")
FACTORY_KW = dict(n_features=5, n_classes=3, min_samples=4,
                  mean_samples=1.0)


class Rows(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor


def _make_store(capacity, n=N_CLIENTS, seed=0, prefetch=False):
    factory = synthetic_lr_factory(n_clients=n, seed=seed, **FACTORY_KW)
    store = ClientStore(factory, capacity, device=CPU, prefetch=prefetch)
    template = Rows(x=torch.full((3,), 0.5), z=torch.zeros(2))
    clients = store.reset(template)
    return store, clients, template


def _write_rows(store, clients, mirror, ids, tag):
    """Write a distinguishable value into each visited row (a training
    update) and keep it on the host for later comparison."""
    for i, s in zip(ids, store.slots(np.asarray(ids))):
        val = np.float32(1.0 + tag + i / 64.0)
        for leaf in clients:
            leaf[int(s)] = float(val)
        mirror[int(i)] = val


def _check_row(store, clients, template, mirror, i):
    """Client ``i``'s row (resident or spilled) equals the last value
    written, or the template if never written."""
    if store.slot_arr[i] >= 0:
        leaves = [leaf[int(store.slot_arr[i])].numpy() for leaf in clients]
    elif int(i) in store._spill:
        leaves = store._spill[int(i)]
    else:
        return   # never materialized
    expect = ([t.numpy() for t in template] if int(i) not in mirror
              else [np.full(t.shape, mirror[int(i)], np.float32)
                    for t in template])
    for got, want in zip(leaves, expect):
        np.testing.assert_array_equal(got, want)


def check_lru_oracle(zones, capacity, n=N_CLIENTS):
    """Drive the store through ``zones`` (id lists, with repeats and
    padding) against an independent LRU oracle."""
    store, clients, template = _make_store(capacity, n=n)
    mirror: dict[int, np.float32] = {}
    oracle: OrderedDict[int, None] = OrderedDict()
    spilled: set[int] = set()
    for t, zone in enumerate(zones):
        zone = [int(i) % n for i in zone]
        uniq = list(dict.fromkeys(zone))
        if len(uniq) > capacity:
            with pytest.raises(ValueError, match="exceeds store capacity"):
                store.ensure(clients, np.asarray(zone))
            continue   # refused before any change
        stats = store.ensure(clients, np.asarray(zone))
        missing = [i for i in uniq if i not in oracle]
        exp = {"hits": len(uniq) - len(missing), "misses": len(missing),
               "evictions": 0, "restores": 0}
        need = len(missing) - (capacity - len(oracle))
        if need > 0:
            for v in [i for i in oracle if i not in set(uniq)][:need]:
                del oracle[v]
                spilled.add(v)
            exp["evictions"] = need
        for i in missing:
            if i in spilled:
                exp["restores"] += 1
                spilled.discard(i)
            oracle[i] = None
        for i in uniq:
            oracle.move_to_end(i)
        assert stats == exp, f"step {t}: {stats} != oracle {exp}"
        assert store.n_resident == len(oracle) <= capacity
        assert list(store.resident_ids) == list(oracle)
        assert set(store.spilled_ids.tolist()) == spilled
        for i in oracle:
            assert store.gid_of[store.slot_arr[i]] == i
        _write_rows(store, clients, mirror, uniq, tag=t)
    for i in range(n):
        _check_row(store, clients, template, mirror, i)
    for i in store.spilled_ids.tolist():
        stats = store.ensure(clients, np.asarray([i]))
        assert stats["restores"] == 1
        _check_row(store, clients, template, mirror, i)
    return store


def check_dense_degeneration(zones, capacity, n=N_CLIENTS):
    """capacity ≥ the visited set: no evictions, no restores, every
    visited client resident."""
    store, clients, _ = _make_store(capacity, n=n)
    visited: set[int] = set()
    for zone in zones:
        zone = [int(i) % min(n, capacity) for i in zone]
        visited.update(zone)
        store.ensure(clients, np.asarray(zone))
    assert store.counters["evictions"] == 0
    assert store.counters["restores"] == 0
    assert set(store.resident_ids.tolist()) == visited
    assert store.spilled_ids.size == 0


ZONES = st.lists(
    st.lists(st.integers(0, N_CLIENTS - 1), min_size=1, max_size=6),
    min_size=1, max_size=14)


@hypothesis.given(zones=ZONES, capacity=st.integers(2, N_CLIENTS))
def test_lru_oracle_property(zones, capacity):
    check_lru_oracle(zones, capacity)


def _zones(rng, size_hi, count_lo, count_hi):
    return [rng.integers(0, N_CLIENTS, size=rng.integers(1, size_hi)).tolist()
            for _ in range(rng.integers(count_lo, count_hi))]


@pytest.mark.parametrize("seed", range(8))
def test_lru_oracle_sampled(seed):
    rng = np.random.default_rng(seed)
    zones = _zones(rng, 7, 3, 15)
    check_lru_oracle(zones, capacity=int(rng.integers(2, N_CLIENTS + 1)))


@hypothesis.given(zones=ZONES, capacity=st.integers(4, N_CLIENTS))
def test_dense_degeneration_property(zones, capacity):
    check_dense_degeneration(zones, capacity)


@pytest.mark.parametrize("seed", range(6))
def test_dense_degeneration_sampled(seed):
    rng = np.random.default_rng(seed)
    zones = _zones(rng, 5, 2, 10)
    check_dense_degeneration(zones, capacity=int(rng.integers(4, 13)))


def test_visit_order_is_eviction_order():
    store, clients, _ = _make_store(capacity=6)
    for i in range(6):
        store.ensure(clients, np.asarray([i]))
    stats = store.ensure(clients, np.asarray([6, 7]))
    assert stats == {"hits": 0, "misses": 2, "evictions": 2, "restores": 0}
    assert set(store.spilled_ids.tolist()) == {0, 1}
    store.ensure(clients, np.asarray([2]))     # re-touching 2 protects it
    stats = store.ensure(clients, np.asarray([8]))
    assert stats["evictions"] == 1
    assert 3 in store.spilled_ids.tolist()
    assert 2 in store.resident_ids.tolist()


def test_working_set_over_capacity_raises():
    store, clients, _ = _make_store(capacity=3)
    with pytest.raises(ValueError, match="exceeds store capacity"):
        store.ensure(clients, np.arange(4))
    # duplicates don't count against the working set
    stats = store.ensure(clients, np.asarray([1, 1, 2, 2, 1]))
    assert stats == {"hits": 0, "misses": 2, "evictions": 0, "restores": 0}


def test_out_of_range_and_unreset_errors():
    store, clients, _ = _make_store(capacity=4)
    with pytest.raises(IndexError):
        store.ensure(clients, np.asarray([N_CLIENTS]))
    with pytest.raises(KeyError, match="not resident"):
        store.slots(np.asarray([5]))
    fresh = ClientStore(store.factory, 4, device=CPU)
    with pytest.raises(RuntimeError, match="reset"):
        fresh.ensure(clients, np.asarray([0]))
    with pytest.raises(ValueError, match="capacity"):
        ClientStore(store.factory, 0, device=CPU)


def test_state_dict_roundtrip_with_spill(tmp_path):
    """Through npz: a fresh store restored from disk has the map, LRU
    order, counters, spill rows and data rows of the saved one."""
    store, clients, _ = _make_store(capacity=4)
    mirror: dict[int, np.float32] = {}
    for t, zone in enumerate([[0, 1, 2], [3, 4], [5, 0], [6, 7]]):
        store.ensure(clients, np.asarray(zone))
        _write_rows(store, clients, mirror, zone, tag=t)
    assert store.spilled_ids.size > 0
    path = str(tmp_path / "store.npz")
    save_client_store(path, store)
    fresh, _, _ = _make_store(capacity=4)
    load_client_store(path, fresh)
    np.testing.assert_array_equal(fresh.gid_of, store.gid_of)
    np.testing.assert_array_equal(fresh.slot_arr, store.slot_arr)
    assert list(fresh.resident_ids) == list(store.resident_ids)
    np.testing.assert_array_equal(fresh.spilled_ids, store.spilled_ids)
    assert fresh.counters == store.counters
    for i in store.spilled_ids.tolist():
        for a, b in zip(fresh._spill[int(i)], store._spill[int(i)]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(fresh.data, store.data):
        assert torch.equal(a, b)
    wrong, _, _ = _make_store(capacity=5)
    with pytest.raises(ValueError, match="capacity"):
        load_client_store(path, wrong)


def check_prefetch_oracle(zones, capacity, n=N_CLIENTS):
    """A prefetch-on store through the scan driver's pattern (ensure this
    zone, stage the next) against a prefetch-off twin and a staging-set
    oracle."""
    sp, cp, template = _make_store(capacity, n=n, prefetch=True)
    s0, c0, _ = _make_store(capacity, n=n)
    staged: set[int] = set()
    mirror_p: dict[int, np.float32] = {}
    mirror_0: dict[int, np.float32] = {}
    zones = [[int(i) % n for i in z] for z in zones]
    zones = [z for z in zones if len(dict.fromkeys(z)) <= capacity]
    for t, zone in enumerate(zones):
        uniq = list(dict.fromkeys(zone))
        miss = [i for i in uniq if sp.slot_arr[i] < 0]
        exp_hits = sum(1 for i in miss if i in staged)
        stp = sp.ensure(cp, np.asarray(zone))
        st0 = s0.ensure(c0, np.asarray(zone))
        assert stp == {**st0, "prefetch_hits": exp_hits,
                       "prefetch_misses": len(miss) - exp_hits}
        staged -= set(miss)
        assert set(sp._staging) == staged
        assert list(sp.resident_ids) == list(s0.resident_ids)
        assert set(sp.spilled_ids.tolist()) == set(s0.spilled_ids.tolist())
        _write_rows(sp, cp, mirror_p, uniq, tag=t)
        _write_rows(s0, c0, mirror_0, uniq, tag=t)
        if t + 1 < len(zones):
            nxt = list(dict.fromkeys(zones[t + 1]))
            todo = [i for i in nxt if sp.slot_arr[i] < 0 and i not in staged]
            assert sp.prefetch(np.asarray(zones[t + 1])) == len(todo)
            staged |= set(todo)
            sp._join_prefetch()
            assert set(sp._staging) == staged
    for a, b in zip(sp.data, s0.data):
        assert torch.equal(a, b)
    for a, b in zip(cp, c0):
        assert torch.equal(a, b)
    for i in range(n):
        _check_row(sp, cp, template, mirror_p, i)
    assert {k: sp.counters[k] for k in STORE_COUNTERS} == \
        {k: s0.counters[k] for k in STORE_COUNTERS}


@hypothesis.given(zones=ZONES, capacity=st.integers(2, N_CLIENTS))
def test_prefetch_oracle_property(zones, capacity):
    check_prefetch_oracle(zones, capacity)


@pytest.mark.parametrize("seed", range(6))
def test_prefetch_oracle_sampled(seed):
    rng = np.random.default_rng(seed)
    zones = _zones(rng, 6, 3, 12)
    check_prefetch_oracle(zones,
                          capacity=int(rng.integers(2, N_CLIENTS + 1)))


def test_prefetch_requires_flag_and_is_idempotent():
    s0, _, _ = _make_store(capacity=4)
    assert s0.prefetch(np.asarray([0, 1])) == 0
    assert "prefetch_hits" not in s0.counters
    sp, cp, _ = _make_store(capacity=4, prefetch=True)
    assert sp.prefetch(np.asarray([0, 1, 1])) == 2
    assert sp.prefetch(np.asarray([0, 1])) == 0   # already staged
    stats = sp.ensure(cp, np.asarray([0, 1]))
    assert stats["prefetch_hits"] == 2 and sp._staging == {}
    assert sp.prefetch(np.asarray([0, 1])) == 0   # now resident


def test_prefetch_failure_raises_at_the_next_ensure():
    """A staging thread that fails is not left behind silently: the next
    ensure() (which joins it) raises with its error as the cause."""
    sp, cp, _ = _make_store(capacity=4, prefetch=True)

    def broken(ids):
        raise OSError("factory unavailable")
    sp.factory = type(sp.factory)(**{**sp.factory.__dict__, "fetch": broken})
    assert sp.prefetch(np.asarray([0, 1])) == 2
    with pytest.raises(RuntimeError, match="prefetch failed") as info:
        sp.ensure(cp, np.asarray([0]))
    assert isinstance(info.value.__cause__, OSError)


def test_counter_keys_stable():
    """The telemetry counters' names come from these tuples."""
    assert STORE_COUNTERS == ("hits", "misses", "evictions", "restores")
    assert PREFETCH_COUNTERS == ("prefetch_hits", "prefetch_misses")
    store, _, _ = _make_store(capacity=3, prefetch=True)
    assert set(store.counters) == set(STORE_COUNTERS + PREFETCH_COUNTERS)


def test_reset_keeps_the_data_block_in_place():
    """A captured window reads the data block by address: reset() zeroes
    it in place and never rebinds it."""
    store, clients, template = _make_store(capacity=4)
    store.ensure(clients, np.asarray([1, 2]))
    ptrs = [c.data_ptr() for c in store.data]
    store.reset(template)
    assert [c.data_ptr() for c in store.data] == ptrs
    assert int(store.data.n_train.sum()) == 4        # empty slots span 1
    assert float(store.data.x_train.abs().sum()) == 0.0


# ------------------------------------------------- against the reference --
@pytest.mark.parametrize("seed", range(6))
def test_store_tracks_the_reference_store(seed):
    """The port's store and the reference's, driven through the same id
    sequences: the same slot map, LRU order, per-call counters and
    spilled ids, and the same data rows byte for byte."""
    import jax.numpy as jnp

    from repro.data import synthetic_lr_factory as ref_factory
    from repro.fl.client_store import ClientStore as RefStore

    rng = np.random.default_rng(100 + seed)
    capacity = int(rng.integers(3, N_CLIENTS))
    zones = [z for z in _zones(rng, 6, 6, 16)
             if len(set(z)) <= capacity]
    store, clients, _ = _make_store(capacity, seed=seed)
    ref = RefStore(ref_factory(n_clients=N_CLIENTS, seed=seed,
                               **FACTORY_KW), capacity)
    r_clients = ref.reset({"x": jnp.full((3,), 0.5),
                           "z": jnp.zeros((2,))})
    for t, zone in enumerate(zones):
        stats = store.ensure(clients, np.asarray(zone))
        r_clients, r_stats = ref.ensure(r_clients, np.asarray(zone))
        assert stats == r_stats, t
        np.testing.assert_array_equal(store.slot_arr, ref.slot_arr)
        np.testing.assert_array_equal(store.gid_of, ref.gid_of)
        assert store.resident_ids.tolist() == ref.resident_ids.tolist()
        assert store.spilled_ids.tolist() == ref.spilled_ids.tolist()
        for got, want in zip(store.data, ref.data):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert store.counters == ref.counters
