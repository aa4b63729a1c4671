"""How far an MoE LM's decode drifts from its teacher-forced ``apply`` in
each package: the measurement behind ``chip_smoke.py``'s bf16 teacher
bound for qwen3-moe-30b-a3b.

On ``qwen3-moe-30b-a3b``'s ``reduced()`` config with the published
routing width put back (128 experts, top-8; d 256, 4 heads of hd 64,
expert width 128, vocab 512), ``--layers`` deep, at capacity factor
E/k = 16 (each expert's capacity is T, so nothing drops and the two
paths compute the same function), with the reference's params carried
over: each package's gap between the decode logits and a teacher-forced
``apply`` over the same tokens, the relative RMS error per position
(``chip_smoke.py``'s measure), in ``--dtype``, and how many (token,
layer) pairs' top-8 sets differ between the two paths in the port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_moe_probe.py \\
        --layers 48 --prompt 2040 --gen 16 --batch 1 --dtype bfloat16

``--arch kimi-k2-1t-a32b`` takes kimi's reduced config with its routing
width put back (384 experts, top-8, one shared expert; factor 48).

prints one JSON line per (layers, seed). Under pytest it runs 4 layers
at 64 tokens on the CPU: in fp32 both packages' gaps stay at float
rounding and the port's decode routes every token as its teacher-forced
pass, and in bf16 both stay within ``PROBE_TOL``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.registry import build_model as ref_build
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "qwen3-moe-30b-a3b"


def _pair(layers: int, dtype: str, seed: int, arch: str = ARCH):
    out = []
    for c in (ref_config(arch), get_config(arch)):
        red = c.reduced()
        out.append(dataclasses.replace(
            red, n_layers=layers, dtype=dtype, moe=dataclasses.replace(
                red.moe, n_experts=c.moe.n_experts, top_k=c.moe.top_k,
                capacity_factor=c.moe.n_experts / c.moe.top_k)))
    rcfg, cfg = out
    ref = ref_build(rcfg)
    params = jax.jit(ref.init)(jax.random.PRNGKey(seed))
    port = build_model(cfg, device="cpu")
    convert.load_lm_reference(port,
                              jax.tree_util.tree_map(np.asarray, params))
    return ref, params, port


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _routes(port, tokens, run) -> list:
    """Each layer's top-k sets (sorted) of the tokens ``run`` feeds it."""
    seen = []

    def hook(module, args, _):
        xf = args[0].reshape(-1, args[0].shape[-1])
        seen.append(moe.route(module, xf, module.cfg)[1].sort(-1).values)
    hooks = [blk.ffn.register_forward_hook(hook) for blk in port.layers]
    try:
        out = run()
    finally:
        for h in hooks:
            h.remove()
    return seen, out


def teacher(layers: int, prompt: int, gen: int, batch: int, dtype: str,
            seed: int, arch: str = ARCH) -> dict:
    ref, params, port = _pair(layers, dtype, seed, arch)
    tok = np.random.default_rng(seed).integers(0, port.cfg.vocab,
                                               (batch, prompt + gen))
    full_r = np.asarray(jax.jit(ref.apply)(params, {"tokens": tok}))
    logits, cache = jax.jit(lambda p, b: ref.prefill(p, b, prompt + gen))(
        params, {"tokens": tok[:, :prompt]})
    step = jax.jit(ref.decode_step)
    gap_r = [_rel(logits[:, -1], full_r[:, prompt - 1])]
    for t in range(prompt, prompt + gen - 1):
        lg, cache = step(params, cache, jnp.asarray(tok[:, t:t + 1]))
        gap_r.append(_rel(lg, full_r[:, t]))
    del full_r
    tokens = torch.as_tensor(tok)
    n = port.cfg.n_layers
    with torch.no_grad():
        routes_full, full_p = _routes(
            port, tokens, lambda: port.apply({"tokens": tokens}).numpy())
        # each layer's sets over (B, S) → the positions decode sees
        forced = [r.reshape(batch, prompt + gen, -1)[:, prompt:]
                  for r in routes_full]
        lg, cache = port.prefill({"tokens": tokens[:, :prompt]},
                                 prompt + gen)
        gap_p = [_rel(lg[:, -1].numpy(), full_p[:, prompt - 1])]
        flips = 0
        for t in range(prompt, prompt + gen - 1):
            routes, (lg, cache) = _routes(
                port, tokens, lambda: port.decode_step(
                    cache, tokens[:, t:t + 1]))
            gap_p.append(_rel(lg.numpy(), full_p[:, t]))
            flips += sum(int((r.reshape(batch, -1) != f[:, t - prompt])
                             .any(-1).sum()) for r, f in zip(routes, forced))
    return {"arch": arch, "layers": layers, "prompt": prompt, "gen": gen, "batch": batch,
            "dtype": dtype, "seed": seed, "reference_rel_rms": gap_r,
            "port_rel_rms": gap_p,
            "port_route_flips": flips,
            "port_routes_compared": n * batch * (gen - 1),
            "apply_gap_packages": _rel(full_p, np.asarray(jax.jit(ref.apply)(
                params, {"tokens": tok})))}


#: a gap of either package's decode from its teacher-forced ``apply`` at
#: 4 layers and 64 tokens, seed 0 (read: fp32 7.0e-7 in both; bf16
#: reference 5.5e-3, port 3.7e-3)
PROBE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_stays_near_teacher_in_both_packages(dtype):
    """Both packages' per-position gaps within ``PROBE_TOL``; in fp32 the
    port's decode routes every token as its teacher-forced pass does."""
    out = teacher(4, 60, 4, 1, dtype, 0)
    assert max(out["reference_rel_rms"]) <= PROBE_TOL[dtype], out
    assert max(out["port_rel_rms"]) <= PROBE_TOL[dtype], out
    if dtype == "float32":
        assert out["port_route_flips"] == 0, out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[4])
    ap.add_argument("--prompt", type=int, default=60)
    ap.add_argument("--gen", type=int, default=4)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--arch", default=ARCH)
    args = ap.parse_args(argv)
    for layers in args.layers:
        for seed in args.seeds:
            print(json.dumps(teacher(layers, args.prompt, args.gen,
                                     args.batch, args.dtype, seed,
                                     args.arch)),
                  flush=True)


if __name__ == "__main__":
    main()
