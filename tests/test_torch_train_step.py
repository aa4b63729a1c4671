"""RWSADMM training of a language model in the port against the JAX
package's: ``launch/steps.py``'s ``make_train_step`` and
``examples/federated_lm_torch.py``.

Both packages start from the reference's params (``model.init(PRNGKey
(0))`` carried over by ``convert``) and take the same token batches.
fp32 on tinyllama-1.1b's ``reduced()`` config (2 layers, d = 256, an
untied head): three chained steps hold the loss, every leaf of x, z and
y and κ at ``STEP_TOL`` for both cross-entropy forms, each step from the
reference's state before it (gradients differ in the last bits, as XLA
and torch sum the matmuls in other orders), except at sign flips: where
x lands on y' within rounding, sgn(y' − x) may come out otherwise in the
two packages, and c(x, z) jumps by 2(z/β + ε), y by that over n (~6e-5
here). Such elements must be ties in the reference (|y' − x| within both
sides' ``STEP_TOL``) and few (≤ ``MAX_FLIP_SHARE`` of a leaf); they are
left out of that step's tolerance. The chained losses hold at
``CHAIN_LOSS_RTOL``. bf16: two
steps follow the reference's promotion (z and y fp32 after the first
step, x after the second) with values at ``BF16_TOL``. The example's first rounds visit the same clients
with losses within ``RUN_LOSS_TOL``.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core.graph import DynamicGraph as RGraph
from repro.core.markov import RandomWalkServer as RWalker
from repro.core.rwsadmm import RWSADMMHparams as RHP
from repro.launch import steps as ref_steps
from repro.models.registry import build_model as ref_build
from repro.models.registry import random_batch as ref_batch
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.launch import steps
from repro_torch.models.registry import build_model
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "tinyllama-1.1b"
ROOT = pathlib.Path(__file__).resolve().parents[1]
HP = dict(beta=2.0, kappa=0.05, epsilon=1e-3)
N_TOTAL = 8
BATCH, SEQ, STEPS = 2, 48, 3
STEP_TOL = dict(atol=1e-6, rtol=1e-5)
MAX_FLIP_SHARE = 1e-4
# Three chained steps from the same weights: the losses read ≤ 1.5e-7
# apart (relative) while x parts by up to 1.2e-3 (the flips and the
# step's gain above).
CHAIN_LOSS_RTOL = 1e-6


def _tie(y):
    """How close x must lie to y for the packages to take other signs of
    y − x: both sides may differ by ``STEP_TOL`` each."""
    return 2 * (STEP_TOL["atol"] + STEP_TOL["rtol"] * y.abs())
# bf16: both packages round every bf16 op (2^-8 relative) and sum their
# bf16 matmuls in other orders; over two chained steps the losses read
# ≤ 1.8e-4 apart (relative, on ~6.7) and the leaves ≤ 7.8e-3 (one bf16 ulp
# at the norms' 1.0). The dtypes are held exactly.
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
BF16_LOSS_TOL = 1e-2
RUN_LOSS_TOL = dict(atol=1e-4, rtol=1e-5)


def _pair(dtype="float32"):
    rcfg = dataclasses.replace(ref_config(ARCH).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    ref = ref_build(rcfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = build_model(cfg, device="cpu")
    state = convert.lm_state_from_reference(
        jax.tree_util.tree_map(np.asarray, params), cfg)
    return rcfg, cfg, ref, params, port, state


def _as_port(tree, cfg):
    """A reference params-shaped tree → the port's dict, each leaf in its
    own dtype."""
    return convert.lm_state_from_reference(
        jax.tree_util.tree_map(np.asarray, tree), cfg)


def _batches(rcfg):
    return [ref_batch(rcfg, BATCH, SEQ, seed=10 + t) for t in range(STEPS)]


def _run_both(dtype, ce_impl, n_steps):
    rcfg, cfg, ref, params, port, state = _pair(dtype)
    r_step = jax.jit(ref_steps.make_train_step(ref, RHP(**HP), N_TOTAL,
                                               ce_impl=ce_impl))
    step = steps.make_train_step(port, RWSADMMHparams(**HP), N_TOTAL,
                                 ce_impl=ce_impl)
    r_st = ref_steps.init_train_state(params, RHP(**HP))
    st = steps.init_train_state(state, RWSADMMHparams(**HP))
    out = []
    for batch in _batches(rcfg)[:n_steps]:
        r_st, r_loss = r_step(r_st, batch)
        st, loss = step(st, {"tokens": torch.as_tensor(
            np.array(batch["tokens"]))})
        out.append((r_st, float(r_loss), st, float(loss)))
    return cfg, out


def _hold_state(cfg, r_st, st, tol, skip=None):
    """x, z, y leaf by leaf at ``tol`` (outside ``skip``'s masks) with the
    reference's dtypes, and κ."""
    for name in ("x", "z", "y"):
        want = _as_port(getattr(r_st, name), cfg)
        got = getattr(st, name)
        assert set(got) == set(want)
        for leaf, w in want.items():
            assert got[leaf].dtype == w.dtype, (name, leaf)
            keep = ~skip[leaf] if skip else torch.ones_like(w, dtype=bool)
            np.testing.assert_allclose(got[leaf].float()[keep].numpy(),
                                       w.float()[keep].numpy(), **tol,
                                       err_msg=f"{name} {leaf}")
    np.testing.assert_allclose(float(st.kappa), float(r_st.kappa),
                               rtol=1e-7)
    assert st.kappa.dtype == torch.float32


def _flips(cfg, r_prev, r_st, st):
    """Where sgn(y' − x) of c_new differs between the packages after a
    step from the same state, and the reference's |y' − x| there in units
    of the tie (:func:`_tie`)."""
    out = {}
    ry, rx = _as_port(r_prev.y, cfg), _as_port(r_st.x, cfg)
    for leaf in ry:
        gap = ry[leaf] - rx[leaf]
        out[leaf] = (torch.sign(gap) != torch.sign(ry[leaf] - st.x[leaf]),
                     gap.abs() / _tie(ry[leaf]))
    return out


@pytest.mark.parametrize("ce_impl", ["gather", "onehot"])
def test_train_steps_match_reference_fp32(ce_impl):
    """Each of three steps from the reference's state before it (so that
    differences do not compound: at β = 2 a step moves x by half its
    gradient, and a 1e-7 change of x moves the next step's x by ~1e-3),
    then the chained losses and κ."""
    rcfg, cfg, ref, params, port, state = _pair()
    hp = RWSADMMHparams(**HP)
    r_step = jax.jit(ref_steps.make_train_step(ref, RHP(**HP), N_TOTAL,
                                               ce_impl=ce_impl))
    step = steps.make_train_step(port, hp, N_TOTAL, ce_impl=ce_impl)
    r_st = ref_steps.init_train_state(params, RHP(**HP))
    for batch in _batches(rcfg):
        tokens = {"tokens": torch.as_tensor(np.array(batch["tokens"]))}
        st = steps.TrainState(*(_as_port(getattr(r_st, n), cfg)
                                for n in ("x", "z", "y")),
                              kappa=torch.tensor(float(r_st.kappa)))
        r_next, r_loss = r_step(r_st, batch)
        st, loss = step(st, tokens)
        np.testing.assert_allclose(float(loss), float(r_loss), **STEP_TOL)
        skip = {}
        for leaf, (flip, gap) in _flips(cfg, r_st, r_next, st).items():
            assert bool((gap[flip] <= 1).all()), (leaf, gap[flip])
            assert int(flip.sum()) <= MAX_FLIP_SHARE * flip.numel() + 1
            skip[leaf] = flip
        _hold_state(cfg, r_next, st, STEP_TOL, skip)
        assert any(bool(v.abs().max() > 0) for v in st.z.values())
        r_st = r_next
    cfg, out = _run_both("float32", ce_impl, STEPS)
    for r_chain, r_loss, chain, loss in out:
        np.testing.assert_allclose(loss, r_loss, rtol=CHAIN_LOSS_RTOL)
        np.testing.assert_allclose(float(chain.kappa), float(r_chain.kappa),
                                   rtol=1e-7)


def test_bf16_steps_follow_reference_promotion():
    cfg, out = _run_both("bfloat16", "gather", 2)
    want = [("bfloat16", "float32", "float32"),
            ("float32", "float32", "float32")]
    for (r_st, r_loss, st, loss), dts in zip(out, want):
        for name, dt in zip(("x", "z", "y"), dts):
            assert {str(v.dtype) for v in
                    jax.tree_util.tree_leaves(getattr(r_st, name))} == {dt}
            assert {v.dtype for v in getattr(st, name).values()} == \
                {getattr(torch, dt)}, name
        np.testing.assert_allclose(loss, r_loss, rtol=BF16_LOSS_TOL)
        _hold_state(cfg, r_st, st, BF16_TOL)


def test_loss_forms_and_refusal():
    rcfg, cfg, ref, params, port, state = _pair()
    port.load_state_dict(state)
    batch = ref_batch(rcfg, BATCH, SEQ, seed=3)
    tokens = {"tokens": torch.as_tensor(np.array(batch["tokens"]))}
    with torch.no_grad():
        for ce_impl in ("gather", "onehot"):
            np.testing.assert_allclose(
                float(port.loss(tokens, ce_impl=ce_impl)),
                float(ref.loss(params, batch, ce_impl=ce_impl)), rtol=1e-6)
        with pytest.raises(ValueError, match="ce_impl"):
            port.loss(tokens, ce_impl="sampled")


# ------------------------------------------------------------- example --
def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_example(rounds, clients, params, cfg):
    """``examples/federated_lm.py``'s loop (its own stream, graph, walker
    and step), keeping every round's client and loss."""
    ex = _load_example("federated_lm")
    model = ref_build(cfg)
    hp = RHP(beta=2.0, kappa=0.001, epsilon=1e-5)
    step = jax.jit(ref_steps.make_train_step(model, hp, n_total=clients))
    rng = np.random.default_rng(0)
    batches = [ex.heterogeneous_stream(cfg.vocab, c, 4, 128, rng)
               for c in range(clients)]
    states = [ref_steps.init_train_state(params, hp) for _ in range(clients)]
    dyn = RGraph(clients, min_degree=3, regen_every=10, seed=0)
    walker = RWalker(seed=1)
    walker.reset(dyn.current())
    y, kappa = states[0].y, jnp.asarray(hp.kappa)
    visits, losses = [], {}
    for r in range(rounds):
        g = dyn.step() if r else dyn.current()
        i_k = walker.step(g) if r else walker.position
        st = ref_steps.TrainState(x=states[i_k].x, z=states[i_k].z, y=y,
                                  kappa=kappa)
        st, loss = step(st, {"tokens": batches[i_k]})
        states[i_k], y, kappa = st, st.y, st.kappa
        visits.append(i_k)
        losses.setdefault(i_k, []).append(float(loss))
    return visits, losses


def test_federated_example_matches_reference(capsys):
    """The twin with the reference's weights: the same clients visited
    and the same losses, round by round."""
    rounds, clients = 5, 4
    ex = _load_example("federated_lm_torch")
    rcfg = dataclasses.replace(
        ref_config(ARCH).reduced(), n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=2, head_dim=64, d_ff=1024, vocab=2048, dtype="float32")
    assert dataclasses.asdict(ex.model_config()) == {
        k: v for k, v in dataclasses.asdict(rcfg).items()
        if k in dataclasses.asdict(ex.model_config())}
    params = ref_build(rcfg).init(jax.random.PRNGKey(0))
    want_visits, want_losses = _reference_example(rounds, clients, params,
                                                  rcfg)
    visits, losses = ex.main(
        ["--rounds", str(rounds), "--clients", str(clients), "--device",
         "cpu"], params=_as_port(params, ex.model_config()))
    assert visits == want_visits
    assert sorted(losses) == sorted(want_losses)
    for c in losses:
        np.testing.assert_allclose(losses[c], want_losses[c],
                                   **RUN_LOSS_TOL)
    out = capsys.readouterr().out
    assert "round    0 client" in out and "per-client loss" in out


def test_federated_example_needs_a_gpu_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load_example("federated_lm_torch").main(["--rounds", "1"])
