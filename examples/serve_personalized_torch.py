"""Serving example on the PyTorch port: batched prefill + greedy decode of
a personalized model, the twin of ``examples/serve_personalized.py``.

The mobile server's y token is the deployable artifact; this serves it
through the port's serving steps (``launch/steps.py``): prefill fills
the KV caches, sliding-window layers keep ring buffers, and every decode
step contracts through the flash-decode kernel on the GPU. The weights
are seeded random ones of the architecture's ``reduced()`` config.
Runs on the GPU unless asked for the CPU.

Run:  PYTHONPATH=src python examples/serve_personalized_torch.py \\
          [--arch gemma3-12b] [--batch 4] [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, \
    make_serve_step  # noqa: E402
from repro_torch.models.registry import build_model, random_batch  # noqa


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, params: dict | None = None) -> torch.Tensor:
    """Serve one batch; returns the generated ids (B, gen). ``params``
    (the ``LM``'s ``state_dict``) replaces the seeded weights."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, device=device)
    if params is None:
        model.init(0)
    else:
        model.load_state_dict(params)
    max_len = args.prompt_len + args.gen + (
        cfg.n_patches if cfg.frontend == "vision_stub" else 0)

    # Batched requests: each row is one request's prompt.
    batch = random_batch(cfg, args.batch, args.prompt_len, seed=7,
                         device=device)
    prefill = make_prefill_step(model, max_len)
    serve = make_serve_step(model)

    t0 = time.perf_counter()
    tok, _, cache = prefill(batch)
    _sync(device)
    print(f"prefill {args.batch}×{args.prompt_len}: "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        tok, _, cache = serve(cache, tok)
        out.append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"decode {args.gen - 1} steps: {dt * 1e3:.0f} ms "
          f"({args.batch * (args.gen - 1) / dt:.1f} tok/s)")
    gen = torch.cat(out, dim=1)
    for i in range(args.batch):
        print(f"request {i}: {gen[i].tolist()}")
    return gen


if __name__ == "__main__":
    main()
