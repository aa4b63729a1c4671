"""RWSADMM federated training of a language model on the PyTorch port,
the twin of ``examples/federated_lm.py``.

A reduced TinyLlama (8 layers, d 512, vocab 2048, fp32) trains on
per-client heterogeneous token streams; the mobile server walks a
dynamic client graph, and each visit runs one RWSADMM zone step
(``launch/steps.py``'s ``make_train_step``) on the client it reaches.
Runs on the GPU unless asked for the CPU.

Run:  PYTHONPATH=src python examples/federated_lm_torch.py \\
          [--rounds 60] [--clients 8] [--device cpu]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.graph import DynamicGraph  # noqa: E402
from repro_torch.core.markov import RandomWalkServer  # noqa: E402
from repro_torch.core.rwsadmm import RWSADMMHparams  # noqa: E402
from repro_torch.launch.steps import TrainState, init_train_state, \
    make_train_step  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402


def heterogeneous_stream(vocab: int, client: int, batch: int, seq: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Markovian token stream with per-client transition bias: the LM
    analogue of the paper's label-skew heterogeneity (the reference's
    draws, in its order)."""
    base = rng.integers(0, vocab, size=(batch, seq))
    # each client prefers a contiguous vocab slice
    lo = (client * vocab // 8) % vocab
    mask = rng.random((batch, seq)) < 0.7
    pref = lo + rng.integers(0, max(2, vocab // 8), size=(batch, seq))
    return np.where(mask, pref % vocab, base)


def model_config():
    """The reference example's reduced TinyLlama."""
    return dataclasses.replace(
        get_config("tinyllama-1.1b").reduced(),
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=2, head_dim=64,
        d_ff=1024, vocab=2048, dtype="float32",
    )


def main(argv=None, params: dict | None = None):
    """Train; returns ``(visits, losses)``: the client of each round and
    each client's losses in visit order. ``params`` (the ``LM``'s
    ``state_dict`` names) replaces the seeded weights."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = model_config()
    model = build_model(cfg, device=device)
    if params is None:
        model.init(0)
        params = {k: v.detach() for k, v in model.named_parameters()}
    params = {k: torch.as_tensor(v, device=device) for k, v in params.items()}
    n_params = sum(v.numel() for v in params.values())
    print(f"model: {cfg.arch_id} ~{n_params / 1e6:.1f}M params")

    hp = RWSADMMHparams(beta=2.0, kappa=0.001, epsilon=1e-5)
    step = make_train_step(model, hp, n_total=args.clients)

    rng = np.random.default_rng(0)
    batches = [torch.as_tensor(heterogeneous_stream(cfg.vocab, c, 4, 128,
                                                    rng), device=device)
               for c in range(args.clients)]
    states = [init_train_state(params, hp) for _ in range(args.clients)]
    dyn = DynamicGraph(args.clients, min_degree=3, regen_every=10, seed=0)
    walker = RandomWalkServer(seed=1)
    walker.reset(dyn.current())

    y, kappa = states[0].y, states[0].kappa
    visits, losses = [], {}
    for r in range(args.rounds):
        g = dyn.step() if r else dyn.current()
        i_k = walker.step(g) if r else walker.position
        st = TrainState(x=states[i_k].x, z=states[i_k].z, y=y, kappa=kappa)
        st, loss = step(st, {"tokens": batches[i_k]})
        states[i_k], y, kappa = st, st.y, st.kappa
        visits.append(i_k)
        losses.setdefault(i_k, []).append(float(loss))
        if r % 10 == 0:
            print(f"round {r:4d} client {i_k} loss {float(loss):.4f}")
    print("\nper-client loss improvement (first visit → last):")
    for c in sorted(losses):
        l = losses[c]
        print(f"  client {c}: {l[0]:.3f} → {l[-1]:.3f} ({len(l)} visits)")
    return visits, losses


if __name__ == "__main__":
    main()
