"""Serving entry point (the JAX package's ``launch/serve.py``): batched
prefill, then greedy decode, for an architecture the port runs, with random
weights from ``--seed`` or the weights of a checkpoint (``--ckpt``: an
``.npz`` of the model's params in the reference's tree, as either
package's ``checkpoint.save_pytree`` writes it). An encoder-decoder
(whisper) encodes the batch's stub frames once, then decodes ``--gen``
steps from each row's first token; a vision stub (qwen2-vl) prefills its
patches ahead of the prompt.

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

from .. import convert, resolve_device
from ..checkpoint import load_pytree
from ..configs import get_config
from ..models.registry import build_model, random_batch
from .steps import make_prefill_step, make_serve_step


def load_model(arch: str, *, reduced: bool = False, device=None,
               seed: int = 0, ckpt: str | None = None):
    """The architecture's model (its ``reduced()`` config when asked) on
    ``device`` with random weights from ``seed``, or those of the
    checkpoint ``ckpt``."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=device)
    if ckpt is None:
        return model.init(seed)
    convert.load_reference_tree(
        model, load_pytree(ckpt, convert.reference_tree(model)))
    return model


def max_len_for(cfg, prompt_len: int, gen: int) -> int:
    """The KV caches' length: prompt and generated tokens, and a vision
    stub's patches ahead of them."""
    return prompt_len + gen + (cfg.n_patches
                               if cfg.frontend == "vision_stub" else 0)


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


def generate_encdec(model, enc: torch.Tensor, tokens: torch.Tensor,
                    gen: int, max_len: int, *, project: bool = False):
    """An encoder-decoder's greedy decode from the encoder output ``enc``
    (B, T, d) and each row's first token ``tokens`` (B, 1): yields
    ``(tokens (B, 1), logits (B, vocab))`` of ``gen`` decode steps. With
    ``project`` the cache holds each layer's cross K/V, made once."""
    serve = make_serve_step(model)
    cache = model.init_cache(tokens.shape[0], max_len, enc, project=project)
    tok = tokens
    for _ in range(gen):
        tok, logits, cache = serve(cache, tok)
        yield tok, logits


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> torch.Tensor:
    """Serve one batch; returns the generated ids: (B, gen), or for an
    encoder-decoder (B, gen + 1), the first token and the gen decoded
    after it."""
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
    ap.add_argument("--ckpt", default=None,
                    help="an .npz of the params in the reference's tree")
    args = ap.parse_args(argv)
    if min(args.batch, args.prompt_len, args.gen) < 1:
        ap.error("--batch, --prompt-len and --gen must be ≥ 1")

    device = resolve_device(args.device)
    model = load_model(args.arch, reduced=args.reduced, device=device,
                       seed=args.seed, ckpt=args.ckpt)
    cfg = model.cfg
    max_len = max_len_for(cfg, args.prompt_len, args.gen)
    batch = random_batch(cfg, args.batch, args.prompt_len, seed=args.seed,
                         device=device)
    _sync(device)
    if cfg.encoder_layers > 0:
        # encoder-decoder: encode once, then token-by-token decode
        t0 = time.perf_counter()
        with torch.no_grad():
            enc = model.encode(batch["frames"])
        _sync(device)
        print(f"encode: {args.batch}×{cfg.encoder_seq} frames in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        tok = batch["tokens"][:, :1]
        t0 = time.perf_counter()
        out = [tok] + [t for t, _ in generate_encdec(model, enc, tok,
                                                     args.gen, max_len)]
        _sync(device)
        return _report(args, out, time.perf_counter() - t0)
    t0 = time.perf_counter()
    steps = generate(model, batch, args.gen, max_len)
    out = [next(steps)[0]]
    _sync(device)
    t_prefill = time.perf_counter() - t0
    print(f"prefill: {args.batch}×{args.prompt_len} tokens "
          f"in {t_prefill * 1e3:.1f} ms")
    out += [tok for tok, _ in steps]
    _sync(device)
    return _report(args, out, time.perf_counter() - t0)


def _report(args, out: list, dt: float) -> torch.Tensor:
    ids = torch.cat(out, dim=1)
    print(f"generated {tuple(ids.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample token ids:", ids[0].tolist())
    return ids


if __name__ == "__main__":
    main()
