"""Serving entry point (the JAX package's ``launch/serve.py``): batched
prefill, then greedy decode, for an architecture the port runs, with random
weights from ``--seed`` (no checkpoint: ``checkpoint/`` is not ported).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-9b --reduced --device cpu \\
      --batch 4 --prompt-len 32 --gen 16

The device defaults to ``cuda``; without a GPU, leaving it unset raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device
from ..configs import get_config
from ..models.registry import build_model, random_batch
from .steps import make_prefill_step, make_serve_step


def load_model(arch: str, *, reduced: bool = False, device=None,
               seed: int = 0):
    """The architecture's LM (its ``reduced()`` config when asked) on
    ``device`` with random weights from ``seed``."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    return build_model(cfg, device=device).init(seed)


def generate(model, batch: dict, gen: int, max_len: int):
    """Yields ``(tokens (B, 1), logits (B, vocab))``: the prefill's greedy
    token, then those of the ``gen − 1`` decode steps that follow it."""
    prefill = make_prefill_step(model, max_len)
    serve = make_serve_step(model)
    tok, logits, cache = prefill(batch)
    yield tok, logits
    for _ in range(gen - 1):
        tok, logits, cache = serve(cache, tok)
        yield tok, logits


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> torch.Tensor:
    """Serve one batch; returns the generated ids (B, gen)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the prompt")
    args = ap.parse_args(argv)
    if min(args.batch, args.prompt_len, args.gen) < 1:
        ap.error("--batch, --prompt-len and --gen must be ≥ 1")

    device = resolve_device(args.device)
    model = load_model(args.arch, reduced=args.reduced, device=device,
                       seed=args.seed)
    batch = random_batch(model.cfg, args.batch, args.prompt_len,
                         seed=args.seed, device=device)
    _sync(device)
    t0 = time.perf_counter()
    steps = generate(model, batch, args.gen, args.prompt_len + args.gen)
    out = [next(steps)[0]]
    _sync(device)
    t_prefill = time.perf_counter() - t0
    print(f"prefill: {args.batch}×{args.prompt_len} tokens "
          f"in {t_prefill * 1e3:.1f} ms")
    out += [tok for tok, _ in steps]
    _sync(device)
    dt = time.perf_counter() - t0
    ids = torch.cat(out, dim=1)
    print(f"generated {tuple(ids.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample token ids:", ids[0].tolist())
    return ids


if __name__ == "__main__":
    main()
