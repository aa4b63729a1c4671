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
``reference`` runs the JAX package on its default backend. The packages
draw minibatches and dropout from different random streams, so their
trajectories match in distribution only. ``--lrs`` sets the SGD steps of
the baselines that take ``lr`` (FedAvg, Ditto, APFL; the reference's
default is 0.05) and leaves the others at their defaults. Run the full
size on a machine with the memory for it; under pytest the probe runs
once per package at a tiny scale on the CPU, so the script keeps working.
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
    rounds = args.rounds * (4 if algo == "walkman" else 1)
    return run_simulation(trainer, rounds=rounds,
                          eval_every=args.eval_every, seed=seed)


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
                                          "gradient"), required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--algos", nargs="+", choices=ALGOS, default=ALGOS)
    ap.add_argument("--lrs", type=float, nargs="+", default=[None],
                    help="SGD steps for FedAvg, Ditto and APFL "
                    "(default: theirs, 0.05)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--eval-every", type=int, default=5)
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


if __name__ == "__main__":
    main()
