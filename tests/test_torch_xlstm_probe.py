"""How well conditioned the xLSTM is, in both packages: the measurements
behind ``test_torch_xlstm.py``'s LONG_TOL and GRAD_SHARE and behind
``chip_smoke.py``'s bf16 teacher bound for xlstm-350m.

On ``xlstm-350m``'s ``reduced()`` config (d 256; ``--layers`` deep, a
multiple of its 6-layer pattern) with the reference's params carried
over:

- ``conditioning``: the largest gap between the two packages' fp32
  logits and their loss gradients (each leaf's, over its largest entry),
  beside the port's own change when every weight is scaled by
  1 + 6e-8·N(0, 1), about one fp32 ulp. Where the two are alike, the
  packages agree to the model's own rounding.
- ``teacher``: each package's own gap between decode logits and a
  teacher-forced ``apply`` over the same tokens, the relative RMS error
  per position (``chip_smoke.py``'s measure), in ``--dtype``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_xlstm_probe.py \\
        --layers 6 12 24 --prompt 300 --gen 8 --seeds 0 1 --dtype bfloat16

prints one JSON line per (probe, layers, seed). Under pytest it runs the
6-layer conditioning probe at 300 tokens on the CPU and holds the
packages' gap within a few times the port's own one-ulp change.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.func import functional_call

from repro.configs import get_config as ref_config
from repro.models.registry import build_model as ref_build
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models.registry import build_model
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "xlstm-350m"
#: one fp32 ulp, relative
ULP = 6e-8


def _pair(layers: int, dtype: str, seed: int):
    rcfg, cfg = (dataclasses.replace(c.reduced(), n_layers=layers,
                                     dtype=dtype)
                 for c in (ref_config(ARCH), get_config(ARCH)))
    ref = ref_build(rcfg)
    params = jax.jit(ref.init)(jax.random.PRNGKey(seed))
    port = build_model(cfg, device="cpu")
    convert.load_lm_reference(port,
                              jax.tree_util.tree_map(np.asarray, params))
    return ref, params, port


def _tokens(cfg, batch: int, seq: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq))


def _grads(model, tokens) -> dict:
    x = {k: v.detach().requires_grad_() for k, v in model.named_parameters()}
    loss = functional_call(model, x, ({"tokens": tokens},))
    return dict(zip(x, torch.autograd.grad(loss, list(x.values()))))


def conditioning(layers: int, seq: int, seed: int) -> dict:
    ref, params, port = _pair(layers, "float32", seed)
    tok = _tokens(port.cfg, 2, seq, seed)
    batch = {"tokens": jnp.asarray(tok)}
    tokens = torch.as_tensor(tok)
    perturbed = copy.deepcopy(port)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in perturbed.parameters():
            p.mul_(1 + ULP * torch.randn(p.shape, generator=gen))
        logits = port.apply({"tokens": tokens})
        logits_perturbed = perturbed.apply({"tokens": tokens})
    logits_ref = torch.as_tensor(np.asarray(ref.apply(params, batch)))
    g_ref = convert.lm_state_from_reference(jax.tree_util.tree_map(
        np.asarray, jax.grad(ref.loss)(params, batch)), port.cfg)
    g, g_perturbed = _grads(port, tokens), _grads(perturbed, tokens)

    def share(a, b, leaf):
        return float((a[leaf] - b[leaf]).abs().max()
                     / g_ref[leaf].abs().max())

    return {"probe": "conditioning", "layers": layers, "seq": seq,
            "seed": seed,
            "logits_gap_packages": float((logits - logits_ref).abs().max()),
            "logits_gap_one_ulp": float(
                (logits - logits_perturbed).abs().max()),
            "logits_max": float(logits_ref.abs().max()),
            "grad_share_packages": max(share(g, g_ref, k) for k in g_ref),
            "grad_share_one_ulp": max(share(g, g_perturbed, k)
                                      for k in g_ref)}


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def teacher(layers: int, prompt: int, gen: int, dtype: str, seed: int
            ) -> dict:
    ref, params, port = _pair(layers, dtype, seed)
    tok = _tokens(port.cfg, 2, prompt + gen, seed)
    full_r = np.asarray(jax.jit(ref.apply)(params, {"tokens": tok}))
    logits, cache = jax.jit(lambda p, b: ref.prefill(p, b, prompt + gen))(
        params, {"tokens": tok[:, :prompt]})
    step = jax.jit(ref.decode_step)
    gap_r = [_rel(np.asarray(logits[:, -1]), full_r[:, prompt - 1])]
    for t in range(prompt, prompt + gen - 1):
        lg, cache = step(params, cache, jnp.asarray(tok[:, t:t + 1]))
        gap_r.append(_rel(np.asarray(lg), full_r[:, t]))
    tokens = torch.as_tensor(tok)
    with torch.no_grad():
        full_p = port.apply({"tokens": tokens}).numpy()
        lg, cache = port.prefill({"tokens": tokens[:, :prompt]},
                                 prompt + gen)
        gap_p = [_rel(lg[:, -1].numpy(), full_p[:, prompt - 1])]
        for t in range(prompt, prompt + gen - 1):
            lg, cache = port.decode_step(cache, tokens[:, t:t + 1])
            gap_p.append(_rel(lg.numpy(), full_p[:, t]))
    return {"probe": "teacher", "layers": layers, "prompt": prompt,
            "gen": gen, "dtype": dtype, "seed": seed,
            "reference_rel_rms": gap_r, "port_rel_rms": gap_p,
            "apply_gap_packages": _rel(full_p, full_r)}


def test_packages_agree_to_the_model_s_rounding():
    """The packages' fp32 logits and gradients part by no more than a few
    times what one ulp on every weight moves the port's own (measured at
    seed 0: logits 2.5e-4 against 1.8e-4, gradients 8.2e-5 against
    5.7e-5 of a leaf's largest entry)."""
    out = conditioning(6, 300, 0)
    assert out["logits_gap_packages"] <= 4 * out["logits_gap_one_ulp"], out
    assert out["grad_share_packages"] <= 4 * out["grad_share_one_ulp"], out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[6])
    ap.add_argument("--prompt", type=int, default=300)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    for layers in args.layers:
        for seed in args.seeds:
            print(json.dumps(conditioning(layers, args.prompt, seed)),
                  flush=True)
            print(json.dumps(teacher(layers, args.prompt, args.gen,
                                     args.dtype, seed)), flush=True)


if __name__ == "__main__":
    main()
