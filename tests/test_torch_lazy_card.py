"""On the card: the lazy plane's captured windows and DP uploads (this
file imports no JAX; its tests skip without a CUDA device).

* The store writes restored and fresh rows into the carry and its data
  block in place, so two captured ``scan`` windows on the lazy plane
  (the second a replay, with evictions between them) equal eager rounds
  on the lazy plane and the dense plane's captured windows bit for bit
  (cuDNN deterministic).
* DP uploads inside a captured ``scan`` window equal eager DP rounds bit
  for bit; ``scan_fused`` refuses them.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.data import build_federated, factory_from_federated, \
    make_image_dataset, pathological_split
from repro_torch.fl import FleetRWSADMMTrainer, RWSADMMTrainer, \
    to_device_data
from repro_torch.models.small import CNN, get_model
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPE, N_CLIENTS, ZONE, BATCH = (8, 8, 1), 20, 3, 6
HP = dict(beta=10.0, kappa=0.01, epsilon=1e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (captured windows, the kernels)")
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def _fed():
    imgs, labels = make_image_dataset(480, shape=SHAPE, seed=0)
    return build_federated(imgs, labels,
                           pathological_split(labels, N_CLIENTS, seed=0))


def _trainer(data, device, fleet=None, **kw):
    model = CNN(SHAPE, c1=4, c2=8, fc=16)
    common = dict(zone_size=ZONE, batch_size=BATCH, solver="closed_form",
                  device=device, **kw)
    if fleet:
        return FleetRWSADMMTrainer(model, data, RWSADMMHparams(**HP),
                                   n_walkers=2, sync_every=2,
                                   fleet_mode=fleet, **common)
    return RWSADMMTrainer(model, data, RWSADMMHparams(**HP), **common)


def _run(tr, engine, windows=3, window=2):
    rng = np.random.default_rng(0)
    state = tr.init_state(0)
    if engine == "eager":
        for r in range(windows * window):
            state, _ = tr.round(state, r, rng)
    else:
        for w in range(windows):
            state, _ = tr.run_chunk(state, tr.schedule(
                window, rng, start_round=w * window), engine)
    torch.cuda.synchronize()
    return state


def _rows(tr, state):
    """x/z rows of the visited clients (from slots or the spill buffer
    on the lazy plane), y and visited, on the host."""
    base = getattr(state, "base", state)
    ids = base.visited.nonzero().squeeze(1).cpu().numpy()
    if tr.store is None:
        x, z = base.clients.x[ids].cpu(), base.clients.z[ids].cpu()
    else:
        rows = []
        for i in ids:
            s = tr.store.slot_arr[i]
            rows.append((base.clients.x[s].cpu(), base.clients.z[s].cpu())
                        if s >= 0 else tuple(torch.from_numpy(r) for r in
                                             tr.store._spill[int(i)]))
        x, z = (torch.stack([r[j] for r in rows]) for j in (0, 1))
    return [x, z, base.server.y.cpu(), base.visited.cpu()]


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", [None, "roundrobin", "simultaneous"])
def test_lazy_captured_scan_equals_eager_and_dense_on_card(cuda_device,
                                                           fleet):
    fed = _fed()
    dense, factory = to_device_data(fed, cuda_device), \
        factory_from_federated(fed)
    cap = 14 if fleet == "simultaneous" else 8
    runs = {}
    for label, data, engine, kw in (
            ("dense scan", dense, "scan", {}),
            ("lazy scan", factory, "scan", {"store_capacity": cap}),
            ("lazy eager", factory, "eager", {"store_capacity": cap}),
            ("lazy scan_fused", factory, "scan_fused",
             {"store_capacity": cap})):
        tr = _trainer(data, cuda_device, fleet, **kw)
        runs[label] = (tr, _run(tr, engine))
    lazy_tr = runs["lazy scan"][0]
    assert lazy_tr.store.counters["evictions"] > 0
    want = _rows(*runs["dense scan"])
    for label in ("lazy scan", "lazy eager"):
        got = _rows(*runs[label])
        assert all(torch.equal(a, b) for a, b in zip(got, want)), label
    assert [w.replays for w in lazy_tr.windows.values()] == [3]
    assert all(torch.isfinite(t).all()
               for t in _rows(*runs["lazy scan_fused"])[:3])


@pytest.mark.cuda
def test_dp_captured_scan_equals_eager_on_card(cuda_device):
    """Two captured DP ``scan`` windows (the second a replay) equal eight
    eager DP rounds bit for bit; ``scan_fused`` refuses DP."""
    imgs, labels = make_image_dataset(300, shape=SHAPE, seed=0)
    data = to_device_data(build_federated(
        imgs, labels, pathological_split(labels, 10, seed=0)), cuda_device)
    out = []
    for engine in ("eager", "scan"):
        tr = RWSADMMTrainer(get_model("mlr", SHAPE), data,
                            RWSADMMHparams(**HP), zone_size=4,
                            batch_size=BATCH, solver="closed_form",
                            device=cuda_device, dp_clip=1.0, dp_noise=1.0)
        state = _run(tr, engine, windows=2, window=4)
        out.append((state.clients.x.clone(), state.server.y.clone()))
    assert all(torch.equal(a, b) for a, b in zip(*out))
    with pytest.raises(ValueError, match="scan_fused does not support DP"):
        tr.run_chunk(tr.init_state(0), tr.schedule(
            2, np.random.default_rng(0)), "scan_fused")
