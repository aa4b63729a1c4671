"""The port's npz checkpoints (``repro_torch.checkpoint``): the
reference's five cases of ``tests/test_checkpoint.py`` on the port's
states, the reference's key paths, and a lazy-plane save with spilled
clients that restores into a fresh store and continues bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_client_store, load_pytree, \
    restore_latest, save_client_store, save_pytree
from repro_torch.core.rwsadmm import RWSADMMHparams, init_states
from repro_torch.data import build_federated, factory_from_federated, \
    make_image_dataset, pathological_split
from repro_torch.fl.base import to_device_data
from repro_torch.fl.fleet_trainer import FleetRWSADMMTrainer
from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer
from repro_torch.models.small import get_model
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

HP = RWSADMMHparams(beta=10.0, kappa=0.001, epsilon=1e-5)


def test_roundtrip_nested(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)}}
    p = str(tmp_path / "ckpt_1.npz")
    save_pytree(p, tree, step=1)
    out = load_pytree(p, tree)
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["c"].dtype == torch.int32


def test_roundtrip_rwsadmm_state(tmp_path):
    client, server = init_states(torch.ones(5), HP, n_clients=3)
    tree = {"client": client._asdict(), "server": server._asdict()}
    p = str(tmp_path / "ckpt_2.npz")
    save_pytree(p, tree)
    out = load_pytree(p, tree)
    assert torch.equal(out["client"]["x"], client.x)
    assert torch.equal(out["server"]["kappa"], server.kappa)


def test_restore_latest(tmp_path):
    for step in (1, 5, 3):
        save_pytree(str(tmp_path / f"ckpt_{step}.npz"),
                    {"w": torch.full((3,), float(step))})
    out, step = restore_latest(str(tmp_path), {"w": torch.zeros(3)})
    assert step == 5
    assert torch.equal(out["w"], torch.full((3,), 5.0))
    assert restore_latest(str(tmp_path / "none"), {"w": torch.zeros(3)}) \
        == (None, -1)


def test_shape_mismatch_raises(tmp_path):
    p = str(tmp_path / "ckpt_1.npz")
    save_pytree(p, {"w": torch.zeros(3)})
    with pytest.raises(ValueError):
        load_pytree(p, {"w": torch.zeros(4)})


def test_key_paths_are_the_references(tmp_path):
    """A nested tree saves under the keys the reference gives it, and a
    trainer state under its NamedTuple fields."""
    from repro.checkpoint import save_pytree as r_save

    tree = {"b": {"d": np.ones(2), "c": np.zeros(1)}, "a": np.arange(3)}
    save_pytree(str(tmp_path / "port.npz"), tree)
    r_save(str(tmp_path / "ref.npz"),
           {"b": {"d": jnp.ones(2), "c": jnp.zeros(1)}, "a": jnp.arange(3)})
    assert sorted(np.load(tmp_path / "port.npz").files) == \
        sorted(np.load(tmp_path / "ref.npz").files)
    tr = _trainer(_fed()[0])
    save_pytree(str(tmp_path / "state.npz"), tr.init_state(0))
    assert sorted(np.load(tmp_path / "state.npz").files) == [
        "clients/x", "clients/z", "server/kappa", "server/round",
        "server/y", "visited"]


def _fed():
    imgs, labels = make_image_dataset(300, shape=(8, 8, 1), seed=0)
    f = build_federated(imgs, labels, pathological_split(labels, 8, seed=0))
    return to_device_data(f, "cpu"), factory_from_federated(f)


def _trainer(data, fleet=False, **kw):
    model = get_model("mlr", (8, 8, 1))
    common = dict(zone_size=4, batch_size=16, solver="closed_form", seed=0,
                  device="cpu", **kw)
    if fleet:
        return FleetRWSADMMTrainer(model, data, HP, n_walkers=3,
                                   sync_every=5, **common)
    return RWSADMMTrainer(model, data, HP, **common)


def _leaves(state):
    base = getattr(state, "base", state)
    out = [base.clients.x, base.clients.z, *base.server, base.visited]
    return out + ([state.tokens] if hasattr(state, "tokens") else [])


def test_fleet_state_checkpoint_roundtrip_continues_identically(tmp_path):
    """The token handoff is a checkpoint: save the fleet's state after a
    7-round window, restore it from disk into a fresh template, continue
    across a rendezvous: losses and every state tensor equal the
    uninterrupted run bit for bit."""
    data, _ = _fed()

    def run(interrupt: bool):
        tr = _trainer(data, fleet=True)
        rng = np.random.default_rng(0)
        state = tr.init_state(0)
        state, stacked = tr.run_chunk(state, tr.schedule(7, rng), "scan")
        losses = stacked["train_loss"].tolist()
        if interrupt:
            path = str(tmp_path / "fleet_ckpt_7.npz")
            save_pytree(path, state, step=7)
            state = load_pytree(path, _trainer(data, fleet=True)
                                .init_state(0))
        state, stacked = tr.run_chunk(
            state, tr.schedule(6, rng, start_round=7), "scan")
        return state, losses + stacked["train_loss"].tolist()

    st_plain, losses_plain = run(interrupt=False)
    st_ckpt, losses_ckpt = run(interrupt=True)
    assert losses_plain == losses_ckpt
    for a, b in zip(_leaves(st_plain), _leaves(st_ckpt)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("engine", ["eager", "scan"])
def test_lazy_checkpoint_roundtrip_with_spill(tmp_path, engine):
    """Interrupt a lazy run with spilled clients, save the state and the
    store, restore both into a fresh trainer (its store freshly reset)
    and continue: the losses, the packed rows and the spill buffer equal
    the uninterrupted run's bit for bit."""
    _, factory = _fed()
    cap = 5   # a round's zone and the padding id fit, eight clients don't

    def steps(tr, state, rng, rounds, start):
        losses = []
        if engine == "eager":
            for r in range(start, start + rounds):
                state, m = tr.round(state, r, rng)
                losses.append(m["train_loss"])
            return state, losses
        for r0 in range(start, start + rounds):   # one-round windows
            state, stacked = tr.run_chunk(
                state, tr.schedule(1, rng, start_round=r0), "scan")
            losses += stacked["train_loss"].tolist()
        return state, losses

    tru = _trainer(factory, store_capacity=cap)
    su, ref_losses = steps(tru, tru.init_state(0),
                           np.random.default_rng(0), 13, 0)
    tri = _trainer(factory, store_capacity=cap)
    rng = np.random.default_rng(0)
    si, losses = steps(tri, tri.init_state(0), rng, 7, 0)
    assert tri.store.spilled_ids.size > 0, "the save must catch a spill"
    save_pytree(str(tmp_path / "state.npz"), si, step=7)
    save_client_store(str(tmp_path / "store.npz"), tri.store)
    # A new trainer's template, then the interrupted trainer's store reset
    # and reloaded (the walker and host RNG carry on, as in the
    # reference's test).
    si = load_pytree(str(tmp_path / "state.npz"),
                     _trainer(factory, store_capacity=cap).init_state(0))
    tri.init_state(0)
    load_client_store(str(tmp_path / "store.npz"), tri.store)
    si, more = steps(tri, si, rng, 6, 7)
    assert losses + more == ref_losses
    for a, b in zip(_leaves(si), _leaves(su)):
        assert torch.equal(a, b)
    assert tri.store.spilled_ids.tolist() == tru.store.spilled_ids.tolist()
    for i in tru.store.spilled_ids.tolist():
        for a, b in zip(tri.store._spill[i], tru.store._spill[i]):
            assert np.array_equal(a, b)
    for a, b in zip(tri.store.data, tru.store.data):
        assert torch.equal(a, b)
