"""Training driver (the JAX package's ``launch/train.py``): RWSADMM
federated rounds over an architecture the port runs.

The mobile server's control plane, as the paper's Algorithm 1: a
dynamic client graph and a random walk over it (``core/graph.py``,
``core/markov.py``, numpy on the host), and at each visit one RWSADMM
zone step (``launch/steps.py``'s ``make_train_step``) on the client it
reaches, each client with its own token stream, its own x and z, and the
token y and κ carried from visit to visit. ``--ckpt`` saves y at the end
in the reference's param tree (``convert.reference_tree``), a file that
``launch/serve.py --ckpt`` and the reference's ``load_pytree`` both read.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --clients 8 --rounds 20 --batch 2 --seq 64 [--device cpu]

The device defaults to ``cuda``; without a GPU, leaving it unset raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import convert, resolve_device
from ..checkpoint import save_pytree
from ..configs import get_config
from ..core.graph import DynamicGraph
from ..core.markov import RandomWalkServer
from ..core.rwsadmm import RWSADMMHparams
from ..models.registry import build_model, random_batch
from .steps import TrainState, init_train_state, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--beta", type=float, default=1.0)
    ap.add_argument("--kappa", type=float, default=0.001)
    ap.add_argument("--epsilon", type=float, default=1e-5)
    ap.add_argument("--min-degree", type=int, default=3)
    ap.add_argument("--ckpt", default=None,
                    help="save the final token y here (.npz, the "
                         "reference's param tree)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if min(args.clients, args.rounds, args.batch) < 1 or args.seq < 2:
        ap.error("--clients, --rounds and --batch must be ≥ 1, --seq ≥ 2")
    return args


def train(model, args: argparse.Namespace) -> tuple[list, list]:
    """``args.rounds`` RWSADMM rounds of ``model`` (an ``LM`` or
    ``EncDecLM`` on its device, holding the starting weights) as
    :func:`main` describes; returns ``(visits, losses)``, the client and
    the loss of each round."""
    cfg, device = model.cfg, model.device
    hp = RWSADMMHparams(beta=args.beta, kappa=args.kappa,
                        epsilon=args.epsilon)
    params = {k: v.detach() for k, v in model.named_parameters()}
    n_params = sum(v.numel() for v in params.values())
    print(f"arch={cfg.arch_id}  params={n_params/1e6:.2f}M  "
          f"clients={args.clients}")

    # Every client gets its own token stream (heterogeneous corpora).
    client_batches = [
        random_batch(cfg, args.batch, args.seq, seed=100 + c, device=device)
        for c in range(args.clients)]

    # One TrainState per client (x_i, z_i) + the wandering y token.
    step = make_train_step(model, hp, n_total=args.clients)
    states = [init_train_state(params, hp) for _ in range(args.clients)]

    dyn = DynamicGraph(args.clients, min_degree=args.min_degree,
                       regen_every=10, seed=0)
    walker = RandomWalkServer(seed=1)
    walker.reset(dyn.current())

    y_token, kappa = states[0].y, states[0].kappa
    visits, losses = [], []
    t0 = time.perf_counter()
    for r in range(args.rounds):
        graph = dyn.step() if r else dyn.current()
        i_k = walker.step(graph) if r else walker.position
        st = states[i_k]
        st = TrainState(x=st.x, z=st.z, y=y_token, kappa=kappa)
        st, loss = step(st, client_batches[i_k])
        states[i_k] = st
        y_token, kappa = st.y, st.kappa
        visits.append(i_k)
        losses.append(float(loss))
        print(f"round {r:4d}  client {i_k:3d}  loss {losses[-1]:8.4f}  "
              f"kappa {float(kappa):.5f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"done: {args.rounds} rounds in {dt:.1f}s "
          f"({dt / args.rounds * 1e3:.0f} ms/round)")

    if args.ckpt:
        save_pytree(args.ckpt, convert.reference_tree(model, y_token),
                    step=args.rounds)
        print(f"saved server token to {args.ckpt}")
    return visits, losses


def main(argv=None, model=None) -> tuple[list, list]:
    """Parse ``argv`` and train; returns ``(visits, losses)``. The model
    is the architecture's (its ``reduced()`` config with ``--reduced``)
    with weights from seed 0, or ``model`` when given (built for that
    config on ``--device``, e.g. holding the reference's weights through
    ``convert.load_lm_reference``)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if model is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        model = build_model(cfg, device=device).init(0)
    elif model.device.type != device.type:
        raise ValueError(f"the model is on {model.device}, --device asks "
                         f"for {device}")
    return train(model, args)


if __name__ == "__main__":
    main()
