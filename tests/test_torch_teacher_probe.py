"""How far served decode logits drift from a teacher-forced ``apply``, for
the sound ring and for known faults in it.

Serves ``recurrentgemma-9b`` through ``launch/serve.py``'s ``generate``
(prefill, then greedy decode past the local rings' wrap) and holds each
step's logits against one ``apply`` over the same tokens, with
``chip_smoke.teacher_forced_errors``: once as written, and once under each
fault, injected into ``models/attention.py`` for the decode steps only:

- ``length_minus_one``: the kernel sees one valid key fewer;
- ``length_plus_one``: one more, up to the ring's size (before the wrap,
  an empty slot);
- ``ring_unwrapped``: local layers decode as global ones (slot
  min(pos, size − 1), every slot valid), so the oldest keys stay;
- ``position_plus_one``: the new token's RoPE position one too far.

Prints one JSON line per (dtype, fault): the largest relative RMS error
over the positions, and each position's.

    PYTHONPATH=src python tests/test_torch_teacher_probe.py

runs it at full width on the GPU in bf16 and fp32 with ``chip_smoke.py``'s
serving shape (batch 4, prompt 2040, 16 tokens), which needs ~50 GB of
device memory. Under pytest it runs the reduced config (fp32, window 64)
on the CPU, where the sound run must stay within ``chip_smoke.py``'s fp32
bound and every fault must exceed it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.registry import build_model, random_batch  # noqa: E402

FAULTS = ("none", "length_minus_one", "length_plus_one", "ring_unwrapped",
          "position_plus_one")


@contextlib.contextmanager
def injected(fault: str):
    """``fault`` patched into ``models/attention.py`` while the block
    runs."""
    kernel, decode, rope = (attention.flash_decode,
                            attention.decode_attention, attention._rope_qk)
    if fault == "length_minus_one":
        attention.flash_decode = lambda q, k, v, length, **kw: kernel(
            q, k, v, length - 1, **kw)
    elif fault == "length_plus_one":
        attention.flash_decode = lambda q, k, v, length, **kw: kernel(
            q, k, v, torch.clamp(length + 1, max=k.shape[1]), **kw)
    elif fault == "ring_unwrapped":
        attention.decode_attention = lambda p, x, cache, cfg, kind: decode(
            p, x, cache, cfg, kind="attn")
    elif fault == "position_plus_one":
        attention._rope_qk = lambda q, k, positions, cfg: rope(
            q, k, positions + 1, cfg)
    elif fault != "none":
        raise ValueError(fault)
    try:
        yield
    finally:
        attention.flash_decode, attention.decode_attention, \
            attention._rope_qk = kernel, decode, rope


def reading(model, batch, gen: int, fault: str) -> dict:
    """Prefill as written, decode ``gen − 1`` steps under ``fault``, then
    the teacher-forced errors."""
    steps = serve.generate(model, batch, gen, batch["tokens"].shape[1] + gen)
    out = [next(steps)]
    with injected(fault):
        out += list(steps)
    ids = torch.cat([tok for tok, _ in out], 1)
    logits = torch.stack([lg for _, lg in out], 1)
    return chip_smoke.teacher_forced_errors(model, batch["tokens"], ids,
                                            logits)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=chip_smoke.LM_ARCH)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--faults", nargs="+", default=list(FAULTS),
                    choices=FAULTS)
    ap.add_argument("--batch", type=int, default=chip_smoke.SERVE["batch"])
    ap.add_argument("--prompt-len", type=int,
                    default=chip_smoke.SERVE["prompt"])
    ap.add_argument("--gen", type=int, default=chip_smoke.SERVE["gen"])
    ap.add_argument("--seed", type=int, default=chip_smoke.SERVE["seed"])
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    base = get_config(args.arch)
    if args.reduced:
        base = base.reduced()
    rows = []
    for dtype in args.dtypes:
        cfg = dataclasses.replace(base, dtype=dtype)
        model = build_model(cfg, device=args.device).init(args.seed)
        batch = random_batch(cfg, args.batch, args.prompt_len,
                             seed=args.seed, device=args.device)
        for fault in args.faults:
            got = reading(model, batch, args.gen, fault)
            rows.append({"arch": cfg.arch_id, "dtype": dtype,
                         "fault": fault, "batch": args.batch,
                         "prompt": args.prompt_len, "gen": args.gen,
                         "window": cfg.window,
                         "rel_rms_max": got["rel_rms_max"],
                         "rel_rms": got["rel_rms"],
                         "argmax_agree": got["argmax_agree"]})
            print(json.dumps(rows[-1]), flush=True)
        del model
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return rows


def test_fp32_bound_passes_the_sound_ring_and_fails_each_fault(capsys):
    """The reduced config on the CPU: prompt 60, 16 tokens, so the
    64-slot rings wrap at step 4."""
    rows = main(["--reduced", "--device", "cpu", "--dtypes", "float32",
                 "--batch", "2", "--prompt-len", "60", "--gen", "16"])
    assert [r["fault"] for r in rows] == list(FAULTS)
    assert len(capsys.readouterr().out.splitlines()) == len(FAULTS)
    bound = chip_smoke.TEACHER_REL_RMS["float32"]
    sound, *faulty = rows
    assert sound["rel_rms_max"] <= bound
    for row in faulty:
        assert row["rel_rms_max"] > bound, row


@pytest.mark.parametrize("fault", FAULTS[1:])
def test_fault_is_lifted_after_its_block(fault):
    before = (attention.flash_decode, attention.decode_attention,
              attention._rope_qk)
    with injected(fault):
        assert (attention.flash_decode, attention.decode_attention,
                attention._rope_qk) != before
    assert (attention.flash_decode, attention.decode_attention,
            attention._rope_qk) == before


if __name__ == "__main__":
    main()
