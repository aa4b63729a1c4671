"""Where the baselines diverge on the CIFAR-shaped CNN configuration.

Runs each baseline (FedAvg, Per-FedAvg, pFedMe, Ditto, APFL, Walkman) on
the paper's CIFAR-10 CNN (c1 = 16, c2 = 32, fc = 512) over the repo's
``make_cifar_like`` stand-in, split with ``pathological_split`` over
n = 100 clients, batch 20, 10 clients a round (Walkman: one, 4× the
rounds), in one package per call, and prints one JSON line per
(algorithm, learning rate, seed): the evaluations every ``--eval-every``
rounds (accuracy and losses) and the first evaluated round whose loss is
not finite (null if none).

    PYTHONPATH=src python tests/test_torch_cnn_baselines_probe.py \\
        --package port
    PYTHONPATH=src JAX_PLATFORMS=cpu python \\
        tests/test_torch_cnn_baselines_probe.py --package reference

``port`` runs ``repro_torch`` on ``--device`` (default ``cuda``, TF32
off); ``lockstep`` runs both round by round on the reference's draws;
``gradient`` compares one minibatch gradient on the CPU (and the
port's fp32 against its float64) and counts max-pool near-ties;
``inject`` runs the reference's fp32 rounds up to ``--rounds`` − 1, then
round ``--rounds`` from that state in both packages, in float64 (held as
the float64 run tier holds a round) and in fp32; ``reference`` runs the
JAX package on its default backend. Both packages start a seed from the
same weights and draw the same minibatches and dropout masks, so in fp32
they follow one trajectory until the last bits of their gradients grow
(max-pool near-ties at full width); ``--perturb EPS`` starts a run from
its initial state scaled by the fp32 number nearest 1 + EPS, which
measures how far a package parts from itself over the same rounds.
``--lrs`` sets the SGD steps of the baselines that take ``lr`` (FedAvg,
Ditto, APFL; the reference's default is 0.05) and leaves the others at
their defaults. Run the full size on a machine with the memory for it;
under pytest the probe runs at a tiny scale on the CPU, so the script
keeps working.
"""
from __future__ import annotations

import argparse
import json
import math

import pytest

ALGOS = ("fedavg", "perfedavg", "pfedme", "ditto", "apfl", "walkman")
TAKES_LR = ("fedavg", "ditto", "apfl")


def _kwargs(algo, lr):
    if algo == "walkman":
        return {"beta": 3.0}
    kw = {"clients_per_round": 10}
    if lr is not None and algo in TAKES_LR:
        kw["lr"] = lr
    return kw


def run_port(args, algo, lr, seed):
    import torch

    from repro_torch.baselines import REGISTRY
    from repro_torch.data import build_federated, pathological_split
    from repro_torch.data.synthetic_images import make_cifar_like
    from repro_torch.fl.base import to_device_data
    from repro_torch.fl.simulation import run_simulation
    from repro_torch.models.small import CNN

    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    imgs, labels = make_cifar_like(args.samples, seed=seed)
    parts = pathological_split(labels, args.clients, seed=seed)
    data = to_device_data(build_federated(imgs, labels, parts), args.device)
    c1, c2, fc = args.widths
    trainer = REGISTRY[algo](CNN((32, 32, 3), c1=c1, c2=c2, fc=fc), data,
                             device=args.device, **_kwargs(algo, lr))
    perturb_init(trainer, args.perturb, "port")
    rounds = args.rounds * (4 if algo == "walkman" else 1)
    return run_simulation(trainer, rounds=rounds,
                          eval_every=args.eval_every, seed=seed)


def run_reference(args, algo, lr, seed):
    from repro.baselines import REGISTRY
    from repro.data import pathological_split
    from repro.data.loader import build_federated
    from repro.data.synthetic_images import make_cifar_like
    from repro.fl.base import to_device_data
    from repro.fl.simulation import run_simulation
    from repro.models.small import make_cnn

    imgs, labels = make_cifar_like(args.samples, seed=seed)
    parts = pathological_split(labels, args.clients, seed=seed)
    data = to_device_data(build_federated(imgs, labels, parts))
    c1, c2, fc = args.widths
    trainer = REGISTRY[algo](make_cnn((32, 32, 3), c1=c1, c2=c2, fc=fc),
                             data, **_kwargs(algo, lr))
    perturb_init(trainer, args.perturb, "reference")
    rounds = args.rounds * (4 if algo == "walkman" else 1)
    return run_simulation(trainer, rounds=rounds,
                          eval_every=args.eval_every, seed=seed)


def perturb_init(trainer, eps: float, package: str) -> None:
    """Scale every floating leaf of the trainer's initial state by the
    fp32 number nearest 1 + ``eps`` (1 ± 1e-7 is one ulp of 1 either
    way), so that a run starts one rounding away from its seed's state:
    the spread of such runs is the package's own sensitivity."""
    if not eps:
        return
    import numpy as np

    factor, init = np.float32(1.0 + eps), trainer.init_state
    if package == "port":
        import torch

        def scale(tree):
            if isinstance(tree, torch.Tensor):
                return tree * float(factor) if tree.is_floating_point() \
                    else tree
            return type(tree)(*(scale(t) for t in tree))
    else:
        import jax
        import jax.numpy as jnp

        def scale(tree):
            return jax.tree_util.tree_map(
                lambda a: a * factor if jnp.issubdtype(a.dtype, jnp.floating)
                else a, tree)
    trainer.init_state = lambda *a, **kw: scale(init(*a, **kw))


def run_lockstep(args, algo, lr, seed):
    """Both packages round by round from the same initial state, the port
    (on ``--device``) handed the batches and keep masks the reference's
    key chain draws, the cohorts and round keys from one host RNG: after
    each round the largest difference of the global model (and of the
    personal models), and whether each side is finite."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import test_torch_baselines as tier
    from repro.baselines import REGISTRY as REF
    from repro.fl.base import to_device_data as ref_device_data
    from repro.models.small import make_cnn
    from repro_torch import convert
    from repro_torch.baselines import REGISTRY
    from repro_torch.data import build_federated, pathological_split
    from repro_torch.data.synthetic_images import make_cifar_like
    from repro_torch.fl.base import to_device_data
    from repro_torch.models.small import CNN

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    imgs, labels = make_cifar_like(args.samples, seed=seed)
    fed = build_federated(imgs, labels,
                          pathological_split(labels, args.clients, seed=seed))
    c1, c2, fc = args.widths
    kw = _kwargs(algo, lr)
    ref = REF[algo](make_cnn((32, 32, 3), c1=c1, c2=c2, fc=fc),
                    ref_device_data(fed), **kw)
    port = REGISTRY[algo](CNN((32, 32, 3), c1=c1, c2=c2, fc=fc),
                          to_device_data(fed, args.device),
                          device=args.device, **kw)
    r_state = ref.init_state(jax.random.PRNGKey(seed))
    state = convert.baseline_state_from_reference(
        algo, jax.tree_util.tree_map(np.asarray, r_state), args.device)
    keep_shapes = ((tier.BATCH, 16, 16, c1), (tier.BATCH, fc))
    n_train = fed.mask_train.sum(axis=1).astype(np.int64)
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(args.rounds):
        sel = rng.choice(args.clients, size=port.m, replace=False)
        key = jax.random.PRNGKey(rng.integers(2**31 - 1))
        draws = tuple(
            (idx.to(args.device),
             None if keep is None else tuple(k.to(args.device)
                                             for k in keep))
            for idx, keep in tier.ref_draws(algo, port, key, sel, n_train,
                                            keep_shapes))
        state = port._round_impl(
            state, torch.as_tensor(sel, device=args.device), draws)
        if hasattr(r_state, "v"):
            w, v = ref._round_fn(r_state.w, r_state.v, jnp.asarray(sel), key)
            r_state = r_state._replace(w=w, v=v)
        else:
            r_state = r_state._replace(
                w=ref._round_fn(r_state.w, jnp.asarray(sel), key))
        row = {"round": r + 1}
        for name in ("w", "v")[:len(state)]:
            got = getattr(state, name).cpu().numpy()
            want = convert._flat_rows(
                jax.tree_util.tree_map(np.asarray, getattr(r_state, name)),
                got.ndim - 1).numpy()
            row[name] = {"max_abs_diff": float(np.abs(got - want).max()),
                         "max_abs": float(np.abs(want).max()),
                         "port_finite": bool(np.isfinite(got).all()),
                         "reference_finite": bool(np.isfinite(want).all())}
        rows.append(row)
    return rows


def run_inject(args, algo, lr, seed):
    """The reference's own fp32 run (its ``round``, as ``run_simulation``
    draws cohorts and round keys) for ``--rounds`` − 1 rounds, then round
    ``--rounds`` from that state in both packages on the CPU: in fp32 (the
    port handed the fp32 draws) and in float64 (the port handed the
    reference's 64-bit draws; the largest gap of each leaf as the float64
    run tier reads it, against its ``TOL``), and the port's float64 round
    on the fp32 draws (whether those batches blow the round up without
    fp32 rounding). Per round before, the reference's largest |w| and
    whether w is finite."""
    import dataclasses

    import jax
    import numpy as np
    import torch

    import test_torch_baselines as tier
    from test_torch_run_float64 import TOL, _double, _ref_step, _widen, \
        gap, rows64
    from repro.baselines import REGISTRY as REF
    from repro.fl.base import to_device_data as ref_device_data
    from repro.models.small import make_cnn
    from repro_torch import convert
    from repro_torch.baselines import REGISTRY
    from repro_torch.data import build_federated, pathological_split
    from repro_torch.data.synthetic_images import make_cifar_like
    from repro_torch.fl.base import to_device_data
    from repro_torch.models.small import CNN

    if algo == "walkman":
        raise ValueError("the inject mode runs the cohort baselines")
    imgs, labels = make_cifar_like(args.samples, seed=seed)
    fed = build_federated(imgs, labels,
                          pathological_split(labels, args.clients, seed=seed))
    c1, c2, fc = args.widths
    kw = _kwargs(algo, lr)
    ref = REF[algo](make_cnn((32, 32, 3), c1=c1, c2=c2, fc=fc),
                    ref_device_data(fed), **kw)
    r_state = ref.init_state(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    before = []
    for r in range(args.rounds - 1):
        r_state, _ = ref.round(r_state, r, rng)
        w = rows64(r_state.w, 0)
        before.append({"round": r + 1, "max_abs_w": float(np.abs(w).max()),
                       "finite": bool(np.isfinite(w).all())})
    sel = ref.select_clients(args.rounds - 1, rng, ref.m)
    key = jax.random.PRNGKey(rng.integers(2**31 - 1))
    keep_shapes = ((tier.BATCH, 16, 16, c1), (tier.BATCH, fc))
    n_train = fed.mask_train.sum(axis=1).astype(np.int64)
    state = convert.baseline_state_from_reference(
        algo, jax.tree_util.tree_map(np.asarray, r_state))
    out = {"round": args.rounds, "rounds_before": before}
    for dtype in ("float32", "float64"):
        wide = dtype == "float64"
        data = to_device_data(fed, "cpu")
        model = CNN((32, 32, 3), c1=c1, c2=c2, fc=fc)
        if wide:
            data = data._replace(x_train=data.x_train.double())
            model = model.double()
        port = REGISTRY[algo](model, data, device="cpu", **kw)
        with jax.enable_x64(wide):
            ref_r = REF[algo](make_cnn((32, 32, 3), c1=c1, c2=c2, fc=fc),
                              ref_device_data(dataclasses.replace(
                                  fed, x_train=fed.x_train.astype(
                                      np.float64))), **kw) if wide else ref
            draws = tier.ref_draws(algo, port, key, sel, n_train,
                                   keep_shapes)
            want = _ref_step(algo, ref_r, _widen(r_state) if wide
                             else r_state, sel, key)
        got = port._round_impl(_double(state) if wide else state,
                               torch.as_tensor(sel), draws)
        if wide:
            # the fp32 run's own batches (the x64 key chain draws others)
            w = port._round_impl(_double(state), torch.as_tensor(sel),
                                 fp32_draws).w
            out["float64_on_fp32_draws"] = {
                "max_abs": float(w.abs().max()),
                "finite": bool(torch.isfinite(w).all())}
        fp32_draws = draws
        row = {}
        for leaf, lead in (("w", 0), ("v", 1))[:len(got)]:
            g, w = getattr(got, leaf), rows64(getattr(want, leaf), lead)
            row[leaf] = {"gap": gap(g.double(), w),
                         "max_abs": float(np.abs(w).max()),
                         "port_finite": bool(torch.isfinite(g).all()),
                         "reference_finite": bool(np.isfinite(w).all())}
        out[dtype] = row
    out["float64_within_tol"] = all(
        v["gap"] <= TOL for v in out["float64"].values())
    out["tol"] = TOL
    return out


def run_gradient(args, seed, lr):
    """``--steps`` SGD steps of one client's CNN (batch 20, the keep masks
    and batches of the reference's key chain) from the same weights: the
    reference (jitted, as its trainers, on the CPU), the port on the CPU
    in fp32, and, with ``--device cuda``, the port on the card with
    cuDNN's default and its deterministic algorithms, TF32 off. Per step, each
    gradient's largest gap to the reference's (the card's to the port's
    CPU run) relative to its largest entry, and the weights' largest gap
    after the step. Step 0 also reports how many of conv2's outputs the
    two packages compute bit for bit, and how many of the 2 × 2 max-pool
    windows after conv2 pick another entry in fp32 than in float64
    (near-ties: the gradient flows through the picked entry only)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.func import functional_call, grad

    import test_torch_baselines as tier
    from repro.models.small import make_cnn
    from repro_torch import convert
    from repro_torch.core.tree import ParamLayout
    from repro_torch.data.synthetic_images import make_cifar_like
    from repro_torch.models.small import CNN, cross_entropy

    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    c1, c2, fc = args.widths
    imgs, labels = make_cifar_like(args.samples, seed=seed)
    ref = make_cnn((32, 32, 3), c1=c1, c2=c2, fc=fc)
    params = ref.init(jax.random.PRNGKey(seed))

    def ref_loss(p, x, y, key):
        logits = ref.apply(p, x, train=True, rng=key)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                             y[:, None], 1))
    ref_grad = jax.jit(jax.grad(ref_loss))
    models = {}

    def port_grad(w, xb, yb, keep, dtype=torch.float32):
        dev = w.device
        if (dev, dtype) not in models:
            models[dev, dtype] = CNN((32, 32, 3), c1=c1, c2=c2,
                                     fc=fc).to(dev, dtype)
        model = models[dev, dtype]
        layout = ParamLayout.from_module(model)
        x = torch.as_tensor(xb).to(dev, dtype)
        y = torch.as_tensor(yb).long().to(dev)
        keep = tuple(torch.as_tensor(np.array(k)).to(dev) for k in keep)
        return layout.flatten(grad(lambda p: cross_entropy(functional_call(
            model, p, (x,), {"train": True, "keep": keep}), y))(
                layout.views(w.to(dtype))))

    def flat(tree):
        return convert._flat_rows(jax.tree_util.tree_map(np.asarray, tree),
                                  0)
    runs = {"cpu": flat(params)}
    if torch.device(args.device).type == "cuda":
        runs.update({"card": runs["cpu"].to(args.device),
                     "card_deterministic": runs["cpu"].to(args.device)})
    w_ref, steps = params, []
    for t in range(args.steps):
        key = jax.random.PRNGKey(100 + 1000 * seed + t)
        idx, keep = tier._ref_draw(key, args.samples,
                                   ((tier.BATCH, 16, 16, c1),
                                    (tier.BATCH, fc)))
        xb, yb = imgs[idx], labels[idx]
        g_ref = flat(ref_grad(w_ref, jnp.asarray(xb), jnp.asarray(yb), key))
        w_ref = jax.tree_util.tree_map(lambda a, b: a - lr * b, w_ref,
                                       ref_grad(w_ref, jnp.asarray(xb),
                                                jnp.asarray(yb), key))
        row, grads = {"step": t}, {}
        for name, w in runs.items():
            torch.backends.cudnn.deterministic = name == "card_deterministic"
            grads[name] = port_grad(w, xb, yb, keep).cpu()
            runs[name] = w - lr * grads[name].to(w.device)
        torch.backends.cudnn.deterministic = False
        for name, g in grads.items():
            base = g_ref if name == "cpu" else grads["cpu"]
            row[f"{name}_grad_gap"] = float((g - base).abs().max()) / float(
                base.abs().max())
            row[f"{name}_w_gap"] = float((runs[name].cpu() - (
                flat(w_ref) if name == "cpu" else runs["cpu"])).abs().max())
        if t == 0:
            row.update(_near_ties(params, xb, keep, F, jax, jnp, np, torch))
            g64 = port_grad(flat(params).double(), xb, yb, keep,
                            torch.float64)
            row["cpu_fp32_vs_fp64_grad_gap"] = float(
                (grads["cpu"].double() - g64).abs().max()) / float(
                    g64.abs().max())
            row["reference_vs_fp64_grad_gap"] = float(
                (g_ref.double() - g64).abs().max()) / float(g64.abs().max())
        steps.append(row)
    return {"widths": [c1, c2, fc], "steps": steps}


def _near_ties(params, xb, keep, F, jax, jnp, np, torch) -> dict:
    """conv2's outputs bit for bit between the packages on the port's own
    conv2 input, and the max-pool windows after it whose pick differs
    between fp32 and float64."""
    def conv2_out(dt):
        x = torch.as_tensor(xb).permute(0, 3, 1, 2).to(dt)
        w1, w2 = (torch.as_tensor(np.array(params[k]["w"])).to(dt)
                  .permute(3, 2, 0, 1) for k in ("conv1", "conv2"))
        h = F.max_pool2d(torch.relu(F.conv2d(x, w1, padding=2)), 2)
        h = torch.where(torch.as_tensor(np.array(keep[0])), h / 0.75,
                        torch.zeros((), dtype=dt))
        return h, F.conv2d(h, w2, padding=2)
    h32, a32 = conv2_out(torch.float32)
    a64 = conv2_out(torch.float64)[1]
    ref_a = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(h32.permute(0, 2, 3, 1).numpy()),
        jnp.asarray(params["conv2"]["w"]), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    flips = (F.max_pool2d(torch.relu(a32), 2, return_indices=True)[1]
             != F.max_pool2d(torch.relu(a64), 2, return_indices=True)[1])
    return {"conv2_bit_equal_share": float(
                (a32.permute(0, 2, 3, 1).numpy() == ref_a).mean()),
            "pool2_windows": flips.numel(),
            "pool2_fp32_vs_fp64_flips": int(flips.sum())}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("port", "reference", "lockstep",
                                          "gradient", "inject"),
                    required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--algos", nargs="+", choices=ALGOS, default=ALGOS)
    ap.add_argument("--lrs", type=float, nargs="+", default=[None],
                    help="SGD steps for FedAvg, Ditto and APFL "
                    "(default: theirs, 0.05)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--perturb", type=float, default=0.0, metavar="EPS",
                    help="scale the initial state by the fp32 number "
                    "nearest 1 + EPS (port and reference runs)")
    ap.add_argument("--steps", type=int, default=1,
                    help="SGD steps of the gradient mode")
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--samples", type=int, default=12_000)
    ap.add_argument("--widths", type=int, nargs=3, default=[16, 32, 512],
                    metavar=("C1", "C2", "FC"))
    args = ap.parse_args(argv)
    run = {"port": run_port, "reference": run_reference}.get(args.package)
    if args.package == "gradient":
        for lr in [0.05 if lr is None else lr for lr in args.lrs]:
            for seed in args.seeds:
                print(json.dumps({"package": "gradient", "lr": lr,
                                  "seed": seed,
                                  **run_gradient(args, seed, lr)}),
                      flush=True)
        return
    for algo in args.algos:
        for lr in args.lrs if algo in TAKES_LR else [None]:
            for seed in args.seeds:
                if args.package == "inject":
                    print(json.dumps({"package": "inject", "algo": algo,
                                      "lr": lr, "seed": seed,
                                      **run_inject(args, algo, lr, seed)}),
                          flush=True)
                    continue
                if run is None:
                    print(json.dumps({"package": "lockstep", "algo": algo,
                                      "lr": lr, "seed": seed,
                                      "rounds": run_lockstep(args, algo, lr,
                                                             seed)}),
                          flush=True)
                    continue
                history = run(args, algo, lr, seed).history
                evals = [{k: h[k] for k in ("round", "acc", "loss_global",
                                            "loss_personalized") if k in h}
                         for h in history]
                bad = next((e["round"] for e in evals
                            if not all(math.isfinite(v) for k, v in
                                       e.items() if k.startswith("loss"))),
                           None)
                print(json.dumps({"package": args.package, "algo": algo,
                                  "lr": lr, "seed": seed,
                                  "perturb": args.perturb,
                                  "clients": args.clients,
                                  "first_nonfinite_eval_round": bad,
                                  "evals": evals}), flush=True)


def test_lockstep_rounds_agree(capsys):
    """The lockstep mode at a tiny scale: the port follows the reference
    round for round at the round tier's 1e-6."""
    main(["--package", "lockstep", "--device", "cpu", "--algos", "fedavg",
          "ditto", "--rounds", "2", "--clients", "6", "--samples", "300",
          "--widths", "4", "8", "32"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert [(r["algo"], len(r["rounds"])) for r in rows] == [
        ("fedavg", 2), ("ditto", 2)]
    for r in rows:
        for rnd in r["rounds"]:
            for leaf in ("w", "v")[:len(rnd) - 1]:
                assert rnd[leaf]["port_finite"] and \
                    rnd[leaf]["reference_finite"]
                assert rnd[leaf]["max_abs_diff"] <= \
                    1e-6 * (1 + rnd[leaf]["max_abs"]), rnd


def test_gradient_mode_reports(capsys):
    """The gradient mode at a tiny width: one line per seed; there the
    packages' first gradients and every step's weights agree at the round
    tier's 1e-6."""
    main(["--package", "gradient", "--device", "cpu", "--samples", "300",
          "--widths", "4", "8", "32", "--seeds", "0", "1", "--steps", "2"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert [(r["package"], r["lr"], r["seed"], len(r["steps"]))
            for r in rows] == [("gradient", 0.05, 0, 2),
                               ("gradient", 0.05, 1, 2)]
    for r in rows:
        first = r["steps"][0]
        assert first["pool2_windows"] == 10240
        assert 0.0 <= first["conv2_bit_equal_share"] <= 1.0
        assert first["cpu_grad_gap"] <= 1e-6, first
        for step in r["steps"]:
            assert step["cpu_w_gap"] <= 1e-6, step
            assert "card_grad_gap" not in step


@pytest.fixture
def one_thread():
    """One torch thread, as the other port test modules run (this module
    keeps the default for its gradient check, which reads 1.2e-6 on one
    thread against its 1e-6)."""
    threads = torch_threads()
    yield
    torch_threads(threads)


def torch_threads(n=None) -> int:
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1 if n is None else n)
    return before


def test_inject_mode_holds_the_round_in_float64(capsys, one_thread):
    """The inject mode at a tiny width: the reference's state after one
    fp32 round, the second round in both packages in float64 within the
    run tier's ``TOL`` (and in fp32 at the round tier's 1e-6)."""
    main(["--package", "inject", "--device", "cpu", "--algos", "fedavg",
          "--lrs", "0.05", "--rounds", "2", "--clients", "6",
          "--samples", "300", "--widths", "4", "8", "32"])
    (row,) = [json.loads(line) for line in
              capsys.readouterr().out.splitlines()]
    assert row["round"] == 2 and [r["round"] for r in
                                  row["rounds_before"]] == [1]
    assert row["float64_within_tol"], row
    assert row["float32"]["w"]["gap"] <= 1e-6, row
    assert row["float32"]["w"]["port_finite"]
    assert row["float64_on_fp32_draws"]["finite"]


@pytest.mark.parametrize("package", ["port", "reference"])
def test_probe_reports_each_run(package, capsys):
    main(["--package", package, "--device", "cpu", "--algos", "fedavg",
          "walkman", "--lrs", "0.05", "--rounds", "2", "--eval-every", "2",
          "--clients", "6", "--samples", "300", "--widths", "4", "8", "32"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert [(r["package"], r["algo"], r["lr"]) for r in rows] == \
        [(package, "fedavg", 0.05), (package, "walkman", None)]
    assert [e["round"] for e in rows[0]["evals"]] == [2]
    assert [e["round"] for e in rows[1]["evals"]] == [2, 4, 6, 8]
    assert all(r["first_nonfinite_eval_round"] is None for r in rows)



@pytest.mark.parametrize("package", ["port", "reference"])
def test_probe_perturbs_the_initial_state(package, capsys, one_thread):
    """``--perturb``: the run starts from its seed's state scaled by
    1 + EPS (in fp32), so its losses move, and its line says so."""
    args = ["--package", package, "--device", "cpu", "--algos", "fedavg",
            "--rounds", "2", "--eval-every", "2", "--clients", "6",
            "--samples", "300", "--widths", "4", "8", "32"]
    main(args)
    main(args + ["--perturb", "1e-3"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert [r["perturb"] for r in rows] == [0.0, 1e-3]
    (a,), (b,) = (r["evals"] for r in rows)
    assert math.isfinite(a["loss_global"]) and \
        math.isfinite(b["loss_global"])
    assert a["loss_global"] != b["loss_global"]


if __name__ == "__main__":
    main()
