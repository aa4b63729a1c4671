"""The float64 run tier: each trainer of the port held to the reference's
run seed for seed, round after round.

Both packages run in float64 from the reference's initial state
(``convert.baseline_state_from_reference`` for the baselines, the
reference's x, z and y rows for the walker) on the same cohorts, zones
and round keys, and the port is handed the reference's draws (under
``jax.enable_x64`` the reference's ``randint`` and ``bernoulli`` draw
64-bit words, not those of its fp32 runs). After every round each state
leaf (the baselines' w and v, Walkman's and the walker's x, z and y, and
at the end Per-FedAvg's and pFedMe's personalized models) must agree
elementwise within ``TOL``·(1 + |reference|).

In fp32 the two packages part like the reference parts from itself:
the last bits of their gradients differ (XLA and torch sum in other
orders), and on the MLPs and the CNN such a difference grows about ×10
every 8 rounds until the runs are two samples of one distribution (the
fp32 run tier's comments give the reference's own ±1-ulp spread). In
float64 the same growth starts from ~1e-16, so a tight bound holds for
tens of rounds and any gap beyond it is a fault.

``R`` and ``TOL`` are measured by this file's script mode: the reference
against itself with its initial state scaled by (1 + 1e-15), beside the
port against the reference, both as the largest
|Δ| / (1 + |reference|) over a round's leaves:

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python \\
        tests/test_torch_run_float64.py [--kinds mlr mlp cnn]

Measured (torch 2.13.0+cpu, jax 0.9.0 on the CPU), the largest over the
R rounds and the leaves, and the perturbed reference's mean growth a
round from its first reading to its last:

    run (R)                    port     reference at 1 + 1e-15   growth
    cohort baselines, MLR (30) ≤ 4.7e-14  ≤ 1.4e-14 (Per-FedAvg)  ≤ ×1.18
    cohort baselines, MLP (30) ≤ 3.4e-13  ≤ 4.8e-13 (pFedMe)      ≤ ×1.27
    walker, MLR / MLP (30)     ≤ 2.6e-13  ≤ 2.9e-12 (prox-SGD MLP) ≤ ×1.26
    Walkman, MLR / MLP (120)   2.1e-10 / 8.7e-12  2.1e-10 / 9.7e-11  ×1.11 / ×1.09
    reduced CNN (10; Walkman 40), all but pFedMe
                               ≤ 6.0e-14  ≤ 1.4e-13 (prox-SGD)    ≤ ×1.59
    pFedMe, reduced CNN (10)   1.6e-12    2.0e-11                 ×2.44

So every round is held within ``TOL`` = 1e-10, more than 100× above the
reference's own envelope, except pFedMe on the CNN and Walkman's 120
rounds, whose envelopes pass 1e-12: those are held within ``WIDE_TOL``
(100× their envelope's largest reading, rounded up to a power of ten).
Round 1 reads at most 7e-15 everywhere and is held within ``FIRST_TOL``
= 1e-12. The port's gap follows the reference's own envelope round for
round: no trainer parts beyond rounding.

This file runs the cohort baselines and Walkman on MLR and MLP;
``test_torch_run_float64_cnn.py`` the reduced CNN and
``test_torch_run_float64_rwsadmm.py`` RWSADMM's round under both
solvers (split so that the test workers can share the cost).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.baselines as RB
from repro.core.rwsadmm import RWSADMMHparams as RHP
from repro.fl.base import to_device_data as r_device
from repro.fl.rwsadmm_trainer import RWSADMMTrainer as RTrainer
from repro_torch import baselines as TB
from repro_torch import convert
from repro_torch.core.rwsadmm import ClientState, RWSADMMHparams, \
    ServerState
from repro_torch.data import build_federated, make_mnist_like, \
    pathological_split
from repro_torch.fl.base import to_device_data
from repro_torch.fl.rwsadmm_trainer import RWSADMMState, RWSADMMTrainer
from repro_torch.kernels.rwsadmm_update import ops as fused_ops
from repro_torch.kernels.rwsadmm_update.ref import zone_fused_update_ref
from test_torch_baselines import BATCH, KEEP_SHAPES, N_CLIENTS, \
    N_SAMPLES, _block, _models, ref_draws
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-10
#: round 1's bound: an op left in fp32, or a formula off by more than
#: rounding, reads 1e-8 or more there
FIRST_TOL = 1e-12
#: the runs whose own envelope passes TOL / 100 within their rounds
WIDE_TOL = {("pfedme", "cnn"): 1e-8, ("walkman", "mlr"): 1e-7,
            ("walkman", "mlp"): 1e-8}
#: rounds of each model (Walkman, one client a round, runs 4×)
ROUNDS = {"mlr": 30, "mlp": 30, "cnn": 10}
COHORT_SIZE = 3
#: the walker's zone and its solvers' settings (the trainer's defaults:
#: β = 10, κ = 0.001, ε = 1e-5; prox-SGD 10 steps at 0.05)
ZONE = 4
#: the evaluation's fixed seeds (``personalized_params``)
EVAL_SEED = {"perfedavg": 1234, "pfedme": 99}
PERTURB = 1e-15


@dataclasses.dataclass
class Feds:
    """The round tier's 400 mnist_like samples over 8 clients, in float64
    for both packages (the reference's built under ``enable_x64``)."""

    ref: object
    port: object
    n_train: np.ndarray


def make_feds() -> Feds:
    imgs, labels = make_mnist_like(N_SAMPLES, seed=0)
    fed = build_federated(imgs, labels,
                          pathological_split(labels, N_CLIENTS, seed=0))
    wide = dataclasses.replace(fed, x_train=fed.x_train.astype(np.float64),
                               x_test=fed.x_test.astype(np.float64))
    with jax.enable_x64(True):
        r_data = r_device(wide)
    data = to_device_data(fed, "cpu")
    data = data._replace(x_train=data.x_train.double(),
                         x_test=data.x_test.double())
    return Feds(r_data, data, fed.mask_train.sum(axis=1).astype(np.int64))


@pytest.fixture(scope="module")
def feds():
    return make_feds()


def rows64(tree, lead: int) -> np.ndarray:
    """``convert._flat_rows`` in float64: leaves in layout order."""
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return np.concatenate(
        [np.asarray(a, np.float64).reshape(np.shape(a)[:lead] + (-1,))
         for _, a in convert._walk(tree)], axis=-1)


def gap(got, want: np.ndarray) -> float:
    """The smallest ``TOL`` a float64 leaf (a tensor or an array) passes:
    max |Δ| / (1 + |want|)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == np.float64 and got.shape == want.shape
    return float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))


def _widen(tree, scale: float = 0.0):
    """A reference state with its floating leaves in float64 (κ stays the
    fp32 scalar both packages carry), scaled by 1 + ``scale``."""
    def leaf(a):
        a = jnp.asarray(a)
        if a.ndim == 0 or not jnp.issubdtype(a.dtype, jnp.floating):
            return a
        return a.astype(jnp.float64) * (1.0 + scale)
    with jax.enable_x64(True):
        return jax.tree_util.tree_map(leaf, tree)


def _double(tree):
    """The port's state with its floating leaves in float64."""
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.is_floating_point() else tree
    return type(tree)(*(_double(t) for t in tree))


# ------------------------------------------------------------- baselines --
def _baselines(name: str, kind: str, feds: Feds):
    r_model, model = _models(kind)
    kw = {} if name == "walkman" else {"clients_per_round": COHORT_SIZE}
    with jax.enable_x64(True):
        ref = RB.REGISTRY[name](r_model, feds.ref, batch_size=BATCH, **kw)
    # outside x64: the reference's fp32 draw of its initial weights
    r_init = jax.tree_util.tree_map(np.asarray,
                                    ref.init_state(jax.random.PRNGKey(0)))
    port = TB.REGISTRY[name](model.double(), feds.port, batch_size=BATCH,
                             device="cpu", **kw)
    state = _double(convert.baseline_state_from_reference(name, r_init))
    return ref, port, r_init, state


def _fields(name):
    """``[(leaf, state → leaf, leading axes)]`` of a baseline's state, in
    either package."""
    if name == "walkman":
        return [("x", lambda s: s.clients.x, 1),
                ("z", lambda s: s.clients.z, 1), ("y", lambda s: s.y, 0)]
    return [("w", lambda s: s.w, 0)] + (
        [("v", lambda s: s.v, 1)] if name in ("ditto", "apfl") else [])


def _ref_step(name, ref, r_state, sel, key):
    if name == "walkman":
        clients, y, _ = ref._round_fn(r_state.clients, r_state.y,
                                      jnp.asarray(int(sel[0])), key)
        return r_state._replace(clients=clients, y=y,
                                round=r_state.round + 1)
    if name in ("ditto", "apfl"):
        w, v = ref._round_fn(r_state.w, r_state.v, jnp.asarray(sel), key)
        return r_state._replace(w=w, v=v)
    return r_state._replace(w=ref._round_fn(r_state.w, jnp.asarray(sel),
                                            key))


def _personal(name, ref, port, state, r_state, feds, keep_shapes):
    """Per-FedAvg's and pFedMe's personalized models of the evaluation,
    the port handed the reference's fixed-seed draws."""
    keys = jax.random.split(jax.random.PRNGKey(EVAL_SEED[name]), N_CLIENTS)
    clients = np.arange(N_CLIENTS)
    idx, keep = _block([[k] for k in keys], clients, feds.n_train,
                       keep_shapes)
    keep = None if keep is None else tuple(k[0] for k in keep)
    want = rows64(ref.personalized_params(r_state), 1)
    if name == "perfedavg":
        got = port.adapt(state.w, torch.as_tensor(clients), idx[0], keep)
    else:
        got = port.prox_solve(state.w.expand(N_CLIENTS, -1),
                              torch.as_tensor(clients), idx[0], keep)
    return got, want


def baseline_run(name: str, kind: str, feds: Feds, rounds: int,
                 perturb: float = 0.0) -> list[dict]:
    """``rounds`` rounds of one baseline in both packages in float64:
    each round's gap of the port (and, with ``perturb``, of the reference
    started from its state scaled by 1 + ``perturb``) to the reference,
    per leaf."""
    ref, port, r_init, state = _baselines(name, kind, feds)
    keep_shapes = KEEP_SHAPES[kind]
    rng = np.random.default_rng(0)
    r_state = _widen(r_init)
    p_state = _widen(r_init, perturb) if perturb else None
    rows = []
    for r in range(rounds):
        if name == "walkman":
            sel = np.array([rng.integers(N_CLIENTS)])
        else:
            sel = rng.choice(N_CLIENTS, size=COHORT_SIZE, replace=False)
        key = jax.random.PRNGKey(rng.integers(2**31 - 1))
        with jax.enable_x64(True):
            if name == "walkman":
                idx, keep = _block([[key]], sel, feds.n_train, keep_shapes)
                draws = (idx[0],
                         None if keep is None else tuple(k[0] for k in keep))
            else:
                draws = ref_draws(name, port, key, sel, feds.n_train,
                                  keep_shapes)
            r_state = _ref_step(name, ref, r_state, sel, key)
            if p_state is not None:
                p_state = _ref_step(name, ref, p_state, sel, key)
        if name == "walkman":
            state, _ = port._round_impl(state, torch.as_tensor(sel), *draws)
        else:
            state = port._round_impl(state, torch.as_tensor(sel), draws)
        row = {"round": r + 1}
        for leaf, get, lead in _fields(name):
            row[leaf] = gap(get(state), rows64(get(r_state), lead))
        if p_state is not None:
            row["perturbed"] = max(
                gap(rows64(get(p_state), lead), rows64(get(r_state), lead))
                for _, get, lead in _fields(name))
        rows.append(row)
    if name in EVAL_SEED:
        with jax.enable_x64(True):
            got, want = _personal(name, ref, port, state, r_state, feds,
                                  keep_shapes)
        rows[-1]["personal"] = gap(got, want)
    return rows


# --------------------------------------------------------------- RWSADMM --
def _walker_pair(kind: str, solver: str, feds: Feds):
    r_model, model = _models(kind)
    kw = dict(zone_size=ZONE, batch_size=BATCH, solver=solver, seed=0)
    with jax.enable_x64(True):
        ref = RTrainer(r_model, feds.ref, RHP(), scenario=None, **kw)
    r_init = ref.init_state(jax.random.PRNGKey(0))     # fp32, as above
    port = RWSADMMTrainer(model.double(), feds.port, RWSADMMHparams(),
                          device="cpu", **kw)
    return ref, port, jax.tree_util.tree_map(np.asarray, r_init)


def _walker_state(r_init, layout) -> RWSADMMState:
    """The port's state from the reference's: x, z and y rows widened to
    float64, κ and the round counter as the trainer keeps them."""
    x = convert._flat_rows(r_init.clients.x, 1).double()
    z = convert._flat_rows(r_init.clients.z, 1).double()
    y = convert.flat_from_reference(r_init.server.y, layout).double()
    server = ServerState(
        y=y, kappa=torch.tensor(np.asarray(r_init.server.kappa)),
        round=torch.tensor(int(r_init.server.round), dtype=torch.int32))
    return RWSADMMState(ClientState(x, z), server,
                        torch.as_tensor(np.array(r_init.visited)))


def _walker_draws(port, ref, key, idx, n_train, keep_shapes):
    """The reference's draws of one zone round (call under x64): slot j
    under ``split(key, Z)[j]``, prox-SGD step t under its
    ``split(·, steps)[t]``; ``(batch_idx, keep)`` in the port's layout."""
    slot_keys = list(jax.random.split(key, len(idx)))
    if port.solver == "closed_form":
        b, keep = _block([[k] for k in slot_keys], idx, n_train, keep_shapes)
        return b[0], None if keep is None else tuple(k[0] for k in keep)
    steps = [list(jax.random.split(k, ref.inner_steps)) for k in slot_keys]
    return _block(steps, idx, n_train, keep_shapes)


def walker_run(kind: str, solver: str, feds: Feds, rounds: int,
               perturb: float = 0.0) -> list[dict]:
    """``rounds`` zone rounds of the single walker in both packages in
    float64 on the reference's schedule: the reference's eager round
    (``_round_impl``) against the port's, for ``closed_form`` both the
    eager update (``core.rwsadmm.client_round`` and the masked fold) and
    the ``scan_fused`` round through the zone kernel's plain version
    (``kernels/rwsadmm_update/ref.py``: what the fp32 wrapper runs on a
    CPU tensor, handed the float64 tensors the wrapper refuses)."""
    ref, port, r_init = _walker_pair(kind, solver, feds)
    sched = ref.schedule(rounds, np.random.default_rng(0))
    r_state = _widen(r_init)
    p_state = _widen(r_init, perturb) if perturb else None
    variants = {"eager": _walker_state(r_init, port.layout)}
    if solver == "closed_form":
        variants["fused"] = _walker_state(r_init, port.layout)
    rows = []
    for r in range(rounds):
        idx, mask, key = sched.idx[r], sched.mask[r], sched.keys[r]
        args = (jnp.asarray(idx), jnp.asarray(mask),
                jnp.asarray(float(sched.n_i[r])), jnp.asarray(key))
        with jax.enable_x64(True):
            batch_idx, keep = _walker_draws(port, ref, jnp.asarray(key), idx,
                                            feds.n_train, KEEP_SHAPES[kind])
            r_state, _ = ref._round_fn(r_state, *args)
            if p_state is not None:
                p_state, _ = ref._round_fn(p_state, *args)
        row = {"round": r + 1}
        want = {"x": rows64(r_state.clients.x, 1),
                "z": rows64(r_state.clients.z, 1),
                "y": rows64(r_state.server.y, 0)}
        for name, state in variants.items():
            with mock.patch.object(fused_ops, "zone_fused_update",
                                   zone_fused_update_ref):
                state, _ = port._round_impl(
                    state, torch.as_tensor(idx, dtype=torch.int64),
                    torch.as_tensor(mask),
                    torch.as_tensor(key.astype(np.int64)),
                    use_fused=name == "fused", batch_idx=batch_idx,
                    keep=keep)
            variants[name] = state
            for leaf, got in (("x", state.clients.x), ("z", state.clients.z),
                              ("y", state.server.y)):
                row[f"{name}_{leaf}"] = gap(got, want[leaf])
            assert np.array_equal(state.visited.numpy(),
                                  np.asarray(r_state.visited)), r
            assert float(state.server.kappa) == float(r_state.server.kappa)
        if p_state is not None:
            row["perturbed"] = max(
                gap(rows64(p_state.clients.x, 1), want["x"]),
                gap(rows64(p_state.clients.z, 1), want["z"]),
                gap(rows64(p_state.server.y, 0), want["y"]))
        rows.append(row)
    return rows


def assert_within(rows: list[dict], name: str, kind: str) -> None:
    """Every leaf of round 1 within ``FIRST_TOL``, of every later round
    within the run's bound (``WIDE_TOL`` or ``TOL``)."""
    for row in rows:
        tol = FIRST_TOL if row["round"] == 1 else \
            WIDE_TOL.get((name, kind), TOL)
        for leaf, g in row.items():
            if leaf not in ("round", "perturbed"):
                assert g <= tol, (name, kind, tol, row)


def run_case(name: str, kind: str, feds: Feds) -> None:
    """One trainer on one model at this tier's rounds, held."""
    if name in ("closed_form", "prox_sgd"):
        rows = walker_run(kind, name, feds, ROUNDS[kind])
    else:
        rows = baseline_run(name, kind, feds,
                            ROUNDS[kind] * (4 if name == "walkman" else 1))
    assert_within(rows, name, kind)


# ----------------------------------------------------------------- tests --
@pytest.mark.parametrize("kind", ["mlr", "mlp"])
@pytest.mark.parametrize("name", ["fedavg", "perfedavg", "pfedme", "ditto",
                                  "apfl", "walkman"])
def test_baseline_run_matches_reference_in_float64(name, kind, feds):
    run_case(name, kind, feds)


# ----------------------------------------------------------------- script --
def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kinds", nargs="+", default=["mlr", "mlp", "cnn"])
    ap.add_argument("--trainers", nargs="+",
                    default=["fedavg", "perfedavg", "pfedme", "ditto",
                             "apfl", "walkman", "closed_form", "prox_sgd"])
    ap.add_argument("--perturb", type=float, default=PERTURB)
    args = ap.parse_args(argv)
    feds = make_feds()
    for kind in args.kinds:
        for name in args.trainers:
            if name in ("closed_form", "prox_sgd"):
                rows = walker_run(kind, name, feds, ROUNDS[kind],
                                  perturb=args.perturb)
            else:
                rows = baseline_run(
                    name, kind, feds,
                    ROUNDS[kind] * (4 if name == "walkman" else 1),
                    perturb=args.perturb)
            port = [max(v for k, v in row.items()
                        if k not in ("round", "perturbed")) for row in rows]
            pert = [row["perturbed"] for row in rows]
            print(json.dumps({
                "trainer": name, "kind": kind, "rounds": len(rows),
                "port_max": max(port), "perturbed_max": max(pert),
                "perturbed_growth": _growth(pert),
                "port": port, "perturbed": pert}), flush=True)


def _growth(gaps: list[float]) -> float | None:
    """The geometric mean growth a round of a gap sequence, from its first
    nonzero reading to its last."""
    nz = [(i, g) for i, g in enumerate(gaps) if g > 0]
    if len(nz) < 2 or nz[-1][0] == nz[0][0]:
        return None
    (i0, g0), (i1, g1) = nz[0], nz[-1]
    return float((g1 / g0) ** (1.0 / (i1 - i0)))


if __name__ == "__main__":
    main()
