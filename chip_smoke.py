"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device — needs CUDA; prints the card's name and power limit
   (``nvidia-smi``) and turns TF32 off for matmuls and convolutions.
2. build — builds the kernels from ``src/repro_torch`` with ``nvcc``, one
   process per source, all at once (four sources, eight kernels), and
   prints ptxas's registers, spills and static shared memory per entry.
3. kernels — holds each kernel against its plain PyTorch version on the
   card at the paths' shapes and at odd ones, and times the first row of
   each beside its bound: ``zone_update``, ``multizone_update`` and
   ``fused_update`` (padded slots and an idle walker included; bit for
   bit; the zone kernel also at every width, β and live count the Table
   1 grid gives it), ``rglru_scan`` (bit for bit, on both its paths;
   timed at the serve shape and at the training step's), its backward
   ``rglru_scan_bwd`` (bit for bit on both its paths, the ``loop`` taken
   by a one float off, at the training step's shape, timed there on
   both, the serve shape and odd ones; the ``autograd.Function``'s
   gradient against autograd through the plain loop) and
   ``flash_decode`` (fp32 at 1e-5, bf16 at atol 1e-3 + rtol 1e-2 against
   the plain softmax and the split reference; lengths below S, a window,
   a row with no valid key, every hd remainder of the tensor-core
   steps, gemma3-12b's and qwen3-moe-30b-a3b's shapes). Every kernel by
   device time over input sets that together exceed the L2 (cold) and
   over one set (warm), with
   CUDA-graph replay beside; one ``scaled_dot_product_attention`` call
   timed the same way as flash decode's yardstick. Then ``threefry`` (the port of
   ``jax.random``'s sampler): ``threefry_draws`` bit for bit against the
   plain integer ops at the zone's 8 leaves, the fleet's 24, prox-SGD's
   step-major tree, the edge spans and its one-output forms, and
   ``threefry_bits`` at split, fold-in and raw-bits shapes; one round's
   draws timed cold and warm beside their bound on the integer pipe (the
   SM clock read from ``nvidia-smi``), and a cohort's key split.
3a. lm init — every registered config's ``reduced()`` (fp32)
   ``init(seed)`` drawn on the card (along the reference's key tree, a
   ``threefry_bits`` launch for every split, fold-in and block of bits)
   against the same on the CPU, leaf by leaf within ``NORMAL_ULP``
   (constant leaves exactly); ``threefry_bits`` timed at the init's
   block of ``prng.NORMAL_BLOCK`` draws beside its bound. Every later LM
   phase draws its weights on the card (the card-vs-CPU steps copy
   them to the CPU), and a run that draws its own model (``serve.main``,
   the training driver, the federated example) counts its launches from
   after the draw (``counts_from_after_init``); each model's init
   seconds are printed at the end.
4. single-walker path — RWSADMM through ``run_simulation`` on the
   paper's CIFAR-10 CNN at full width (P = 1,068,266), n = 100 clients,
   zone 8, batch 20, ``closed_form`` + ``engine="scan_fused"``: the
   window runs as one CUDA graph (a warm-up round, the capture, one
   replay); checks finite losses, the accuracy report and that the zone
   kernel and ``threefry_draws`` ran once per round, and no other
   threefry entry; steady ms per
   engine with each window's replays, the kernels it launches and the
   device's busy share; then ``eager`` and the fused rounds in lockstep
   from the same seed and weights (``compare_lockstep``: each round from
   the eager state through the kernel at ``KERNEL_TOL``, ``scan_fused``
   bit for bit against the fused rounds, the end states' gap printed).
5. fleet path — the same model and data under a K = 3 walker fleet in
   simultaneous mode (``sync_every=10``): 50 wall steps of ``scan_fused``
   with one multi-zone launch each, steady times per engine, a profile,
   eager and the fused rounds in lockstep; then a round-robin fleet whose
   12 rounds each launch the zone kernel.
5a. scenarios — the paper's infrastructure-less field on the same model
   and data: the single walker under ``field_trial`` (Gauss-Markov
   mobility, lossy links, churn with 20 % stragglers) for 50 rounds of
   ``scan_fused`` in one captured window, and the K = 3 simultaneous
   fleet under ``lossy_links`` for 50 wall steps; each with exactly one
   update launch (``zone_update`` / ``multizone_update``) and one
   ``threefry_draws`` launch a round and no other threefry entry; its
   host columns (client, zone, ``n_i``, ``latency_s``, ``energy_j``,
   staleness, ``comm_bytes``) equal by ``==`` across ``scan_fused``, an
   eager run and the same trainer's ``schedule()`` on the CPU; eager and
   the fused rounds in lockstep; the captured windows
   bit for bit against eager (``scan``) and uncaptured rounds
   (``scan_fused``), cuDNN deterministic; steady ms per round beside the
   ``static_regen`` phases of the same call, ``schedule()``'s host ms a
   window and the masks' dead-slot share. Then FedAvg under
   ``duty_cycle`` (cohorts only from awake clients, star prices, no
   update kernel) and ``benchmarks/scenario_sweep_torch.py --smoke``.
5b. walks — the walk policies on the same model and data: the single
   walker with ``transition="metropolis"``, with ``walk_policy=
   "staleness"`` and ``"label_skew"`` (γ = 0.5), with ``staleness`` and
   ``batched_walk=True``, and the K = 3 simultaneous fleet under
   ``staleness``; each 50 rounds (wall steps) of ``scan_fused`` in one
   captured window with exactly one update launch and one
   ``threefry_draws`` launch a round; host columns and importance
   weights (``iw``, every walker's ``weight_history``) equal by ``==``
   across ``scan_fused``, eager and the CPU's ``schedule()``; eager and
   the fused rounds in lockstep for 5 rounds, each round from the eager
   state through the kernel at ``KERNEL_TOL`` and ``scan_fused`` bit for
   bit against the fused rounds (the end states' gap printed); captured
   windows bit for bit over two windows, the second a replay with new
   weights (``batched_walk`` walks another stream than eager: held to
   the CPU's ``schedule()`` and to its rounds uncaptured); a window's
   dispatched operations exactly the static trainer's (Metropolis, a
   uniform chain, must also carry no ``iw``) or those and the ``iw``
   fold's; steady ms, busy share and kernels a round beside the
   ``static_regen`` paths of this call, ``schedule()``'s host ms a
   window.
5c. lazy plane — the bounded LRU client store (``LAZY``), cuDNN
   deterministic: the cnn-cifar-n100 single walker on
   ``factory_from_federated`` at capacity 40 (80 rounds of ``scan_fused``
   in windows of 4) and the K = 3 simultaneous fleet at capacity 50 (30
   wall steps in windows of 2), each against its dense run: launches
   exact per round, host columns and losses ``==``, y (tokens) and every
   visited client's x/z bit for bit, store counters (evictions and
   restores > 0) equal to a CPU store over the same ids; steady ms a
   round beside dense, ``ensure()``'s host ms, bytes evicted and
   restored. FedAvg on the store (round metrics ``==`` dense).
   ``benchmarks/scan_scaling_torch.py --lazy-check`` at n = 100,000 in
   its own process (``scan_fused`` prefetch off ≡ on bit for bit,
   ``scan``, host columns ``==`` the CPU's ``schedule()``; µs a round,
   peak device memory and RSS). DP uploads: captured ``scan`` ≡ eager
   bit for bit, one MLR round card vs CPU at 1e-6, ``scan_fused``
   refuses. Telemetry on the store cell ≡ off bit for bit (captures and
   replays equal), the report rendered, the overhead twin at n = 2000
   in its own process within 5 % (the median of 30 interleaved off/on
   pairs' ratios; the trace's own cost printed beside it). A checkpoint
   with spilled rows restored into a fresh trainer continues bit for bit.
6. single-client op — one client's update through ``ops.fused_update``
   at the CNN's width, launched once.
6a. captured windows — on the same CNN, with cuDNN deterministic: the
   captured ``scan`` equals ``eager`` and the captured ``scan_fused``
   equals the same rounds run uncaptured (``_round_impl``, or the
   fleet's step, in a loop), bit for bit, over two windows (the second a
   replay), for the single walker and the K = 3 fleet in both modes.
6b. device parity — one seed on the card and on the host's CPU (TF32
   off): five rounds' batch indices and keep masks bit for bit equal
   (MLR, MLP, both solvers, the CNN), x, z, y after one eager round
   within 1e-6 (MLR and MLP on ``closed_form``); the gaps after five
   rounds printed, not gated.
6c. scaling twins — ``benchmarks/scan_scaling_torch.py`` and
   ``benchmarks/fleet_scaling_torch.py`` at their smoke sizes.
7. baselines — the paper's baselines on the card, launching no update
   kernel (their draws go through threefry, each entry's launches
   counted exactly): the reference's accuracy
   gates (``tests/test_fl_trainers.py``
   at its settings), each run's cohorts, Walkman's visited clients and
   ``comm_bytes`` equal to a numpy replay of the seed's host draws; the
   Table 1 grid through ``benchmarks/table1_torch.py`` (2 datasets × MLR,
   MLP × the six algorithms and ``rwsadmm_cf``, whose rows launch the
   zone kernel; RWSADMM's rank printed beside the reference's seed-0
   cells, not gated; one
   ``rwsadmm_cf`` row again with the kernel's plain version in its place,
   final state held at 1e-6); then
   every baseline on the CNN path's configuration: rounds/s, steady ms
   per round, peak memory and a profiled round's busy share.
7a. paper scripts — ``benchmarks/{convergence,table2_scaling,hyperparam,
   mixing,ablations}_torch.py`` and ``examples/
   personalization_comparison_torch.py`` at the reference's sizes and
   fewer rounds (``PAPER``), then ``examples/quickstart_torch.py`` for
   its full 300 rounds. Gated: the policy sweep's hitting times and
   staleness equal
   a CPU run of the same twin, Table 2's ``comm_mb`` the CPU
   ``schedule()`` of the same trainers, the literal Eq. 11's first step
   0.0, the quickstart's hitting time and MB a round the reference's
   (58; 2.92 and 7.17). The accuracies are printed beside the
   reference's.
8. serve path — RecurrentGemma-9B at full width and one 19-layer pattern
   of its two (bf16, seeded random weights) through ``launch/serve.py``:
   prefill 4 × 2040 tokens (one ``rglru_scan`` launch per RG-LRU layer,
   13) and 15 greedy decode steps (one ``flash_decode`` launch per local
   layer and step, 90; the rings wrap at step 8), each kernel path's
   launches checked; then the decode logits against a teacher-forced
   ``apply`` over the same 2056 tokens, a profiled prefill and decode
   step, and the same generation and check with the same weights in fp32,
   where the bound is tight enough to fail a fault in the ring.
8a. model zoo — gemma3-12b at full width and depth (48 layers: 40 local
   with a 1024-key ring that wraps during the prefill, 8 global; hd 240,
   G = 2), bf16, through the same serve: exactly 720 ``flash_decode``
   launches (48 × 15) and no other kernel, the teacher check, a profiled
   prefill and decode step; its first pattern (6 layers) in fp32 with the
   same weights at the fp32 bound; then tinyllama-1.1b, qwen2-7b (qkv
   bias drawn at random, G = 7) and yi-34b (G = 7) at full width and 2
   layers through the same serve and check. The kernel phase holds flash
   decode at gemma3's shapes (global 2056 keys timed beside SDPA and its
   bound, the full ring, lengths below S; bf16 and fp32).
8b. training — RWSADMM on tinyllama-1.1b at full width and depth (22
   layers, bf16) through ``launch/steps.py``'s ``make_train_step``: three
   clients on the walker, 4 × 2048 tokens a step, five rounds; finite
   losses, x moved, κ decayed, the leaves' dtypes after steps 1 and 2 as
   the reference's promotion gives them, no hand kernel launched; ms a
   step, tokens/s, peak memory. One step of a 2-layer fp32 cut on the
   card against the same step on the CPU, and ``examples/
   federated_lm_torch.py`` at its default size.
8c. xLSTM — xlstm-350m at full width and depth (24 layers: 20 mLSTM, 4
   sLSTM; d 1024; 518,651,904 parameters), bf16, seeded random weights,
   through the same serve: no hand kernel launched, the teacher check, a
   profiled prefill and decode step, one mLSTM and one sLSTM layer
   profiled alone over the prompt; its first pattern (6 layers) in fp32
   with the same weights at the fp32 bound; RWSADMM training at full
   width and depth (three clients, 4 × 512 tokens a step, two rounds;
   the same gates as 8b) and one step of the first pattern in fp32, card
   against CPU.
8d. MoE — qwen3-moe-30b-a3b at full width and depth (48 layers; H 32
   over K 4, hd 64; 128 experts, top-8, width 768; 30,079,320,064 by
   ``param_count``), bf16, seeded random weights, through the same serve
   at the published capacity factor 1.25: exactly 720 ``flash_decode``
   launches (48 × 15) and no other kernel, the prefill's dropped (token,
   expert) slots a layer, a profiled prefill and decode step; then, with
   the same weights at capacity factor 16 (the capacity is T, nothing
   drops), the teacher check on the serve batch's row 0 in bf16 and on
   the first 2 layers in fp32; RWSADMM training at full width cut to 1
   layer (two clients, 4 × 512 tokens, two rounds; the gates of 8b) and
   one fp32 step of that cut card against CPU, after layer 0's top-8
   sets are compared (a flip above a 1e-5 margin fails). The kernel
   phase holds flash decode at qwen3's decode shape (G = 8, hd 64, 2056
   keys; bf16 timed beside SDPA and its bound, fp32, lengths below S).
8e. frontends — whisper-large-v3 and qwen2-vl-2b at full width and
   depth (``phase_whisper``, ``phase_vlm``).
8f. RecurrentGemma training — RWSADMM on recurrentgemma-9b at full
   width cut to one (rglru, rglru, local) group (1,554,071,552 by
   ``param_count``), bf16, two clients, 2 × 2048 tokens a step, three
   rounds: the gates of 8b, with exactly 4 forward and 2 backward scan
   launches a step, all staged, and no flash decode; one fp32 step of
   that cut card against CPU on 1 × 128 tokens; ``python -m
   repro_torch.launch.train --arch recurrentgemma-9b --reduced`` (its
   ``main``) on the card, its scan launches gated exactly.
8g. mesh — the client plane under a one-rank mesh bit for bit,
   kimi-k2-1t-a32b cut to one layer, the dry-run on the card's torch
   (its record's temporaries and bytes accessed gated non-null, its
   roofline row at the H100's constants printed) (``phase_mesh``).
8h. analysis — the capture budget's smoke cells captured on the card
   against ``analysis/capture_budget_torch.json`` (6 captures, each
   window's captured kernel counts), the carry check, a profiled replay
   with no device-to-host copy, ``LiveBytes`` against the allocator on
   a real step (``phase_analysis``).

Ends with a ``{"kernels": [...]}`` line, the paths' summaries, each
model's init seconds, each phase's seconds, the ``nvidia-smi`` line and,
last, ``{"ok": true, "device": {...}}``. Imports nothing of JAX or
``repro``.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 data-sheet peaks (dense): memory bandwidth by part, fp32 non-tensor.
HBM_BYTES_PER_S = {"pcie": 2.0e12, "sxm": 3.35e12}
FP32_FLOP_PER_S = 67e12
# Instructions a clock per SM: four schedulers, each issuing one warp
# instruction (32 results) a clock. No mix of 32-bit integer
# instructions exceeds it (the ALU pipe takes IADD3, LOP3 and SHF, the
# FMA pipe the IMAD forms ptxas gives some adds), so with the H100's SMs
# and the SM clock that nvidia-smi reads it is the peak for the hash.
INT32_OPS_PER_CLOCK_PER_SM = 128
H100_SMS = 132

ENGINES = ("eager", "scan", "scan_fused")
P_CNN = 1_068_266
MAIN = dict(n_samples=12_000, n_clients=100, zone=8, batch=20, rounds=50,
            eager_rounds=5, seed=0)
# benchmarks/fleet_scaling.py's fleet: K = 3 walkers, rendezvous every 10.
FLEET = dict(n_walkers=3, sync_every=10, wall_steps=50, eager_steps=5,
             rr_rounds=12)
# Eager vs scan_fused after a few rounds: the plain and kernel updates
# agree to the last bit or so per round, and on the CNN those ulps move
# the next rounds' gradients at ReLU and max-pool near-ties, so the end
# states part by ~1e-4–1e-3 (7.07e-4 single walker, 7.15e-4 fleet, cuDNN
# deterministic). They are printed beside this scale, never gated:
# compare_lockstep holds each round instead.
EAGER_ATOL = 1e-4
# Kernel vs plain version: x⁺, z⁺ at 1e-6 (same operations, same order,
# both rounding after every operation). y⁺ also at 1e-6 away from sign
# flips of sgn(y − x⁺); each flip may move y⁺ by up to 2(|z⁺|/β + ε)/n
# and is counted and printed, never hidden under the tolerance.
KERNEL_TOL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> tuple[float, str]:
    part = "pcie" if "pcie" in name.lower() else "sxm"
    return HBM_BYTES_PER_S[part], f"H100 {part.upper()} data sheet"


def int32_rate() -> tuple[float, str]:
    """32-bit integer operations a second at the card's maximum SM clock
    (``nvidia-smi --query-gpu=clocks.max.sm``), and how it was made."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    rate = INT32_OPS_PER_CLOCK_PER_SM * H100_SMS * mhz * 1e6
    return rate, (f"{INT32_OPS_PER_CLOCK_PER_SM} int32 instructions a clock"
                  f" per SM × {H100_SMS} SMs × {mhz:.0f} MHz (nvidia-smi "
                  f"clocks.max.sm) = {rate / 1e12:.2f} T/s")


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: profiles ``device_time_ms`` takes before a wrong kernel count fails
PROFILE_TRIES = 3


def device_time_ms(fns, reps: int, graph: bool = True,
                   kernels: int | None = None) -> dict:
    """Device time of one call, each of ``fns`` being one call on its own
    inputs, run in turn ``reps`` times (distinct inputs larger than the
    50 MB L2 between them read it cold). ``profiler``: the kernels' own
    device time per call, summed from ``torch.profiler`` (no host gaps);
    ``graph``: one CUDA graph of all the calls replayed, elapsed CUDA-event
    time per call (back-to-back launches with the graph's own gaps).
    ``kernels``: the kernels one call launches. The profiler can lose a
    kernel's record (the staged backward's cold rows lose one in 20), and
    a sum over the calls then reads low by the lost share, so where
    ``kernels`` is given the time a call is the recorded kernels' mean
    times ``kernels``, and ``records_lost`` says how many were lost. A
    profile that recorded none, or more than the calls launch, is taken
    again, at most ``PROFILE_TRIES`` times in all, and the last one
    raises."""
    import torch

    for fn in fns:                   # warm: builds, attributes, plans
        fn()
    calls = len(fns) * reps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == cuda and e.self_device_time_total > 0]
        total = sum(e.self_device_time_total for e in rows) / 1e3
        recorded = sum(e.count for e in rows)
        out = {"profiler": total / calls,
               "kernels_per_call": recorded / calls,
               "by_kernel": {e.key[:80]: e.self_device_time_total / calls
                             / 1e3 for e in rows},
               "profiles": attempt + 1}
        if kernels is None:
            break
        expected = kernels * calls
        out["records_lost"] = expected - recorded
        if 0 < recorded <= expected:
            out["profiler"] = total / recorded * kernels
            if recorded < expected:
                log(f"device_time_ms: the profile recorded {recorded} of "
                    f"the {expected} kernels launched; the time a call is "
                    f"the recorded ones' mean × {kernels} "
                    f"({out['profiler']:.5f} ms, the sum over the calls "
                    f"{total / calls:.5f})")
            break
        log(f"device_time_ms: the profile recorded {recorded} kernels for "
            f"{expected} launched (by kernel {out['by_kernel']}); "
            f"profiling again")
    else:
        raise AssertionError(f"device_time_ms: {PROFILE_TRIES} profiles "
                             f"recorded "
                             f"{recorded} kernels for {expected} launched")
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for fn in fns:
                fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                for fn in fns:
                    fn()
        g.replay()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        out["graph"] = start.elapsed_time(end) / (5 * calls)
        del g
    return out


def ptxas_entries(lib: Path) -> dict:
    """Registers, spills and static shared memory of each kernel entry in
    a library's ``-Xptxas -v`` log, by a short name: base, element type
    and split (``flash_decode_split<bf16,64>``)."""
    import re

    out, name = {}, None
    for line in Path(f"{lib}.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"\d+([a-z_]+?)(?:I|E)", mangled.split(
                "_cu_")[-1]).group(1)
            args = (["bf16"] if "bfloat16" in mangled else
                    ["f32"] if re.search(r"I[f]", mangled) else [])
            args += re.findall(r"Li(\d+)E", mangled)
            name = base + (f"<{','.join(args)}>" if args else "")
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(smem.group(1)) if smem else 0
    return out


def _wrappers():
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.rglru_scan.ops import rglru_scan, rglru_scan_bwd
    from repro_torch.kernels.rwsadmm_update import ops
    from repro_torch.kernels.threefry import ops as tf

    return {"zone_update": ops.zone_fused_update,
            "multizone_update": ops.multizone_fused_update,
            "fused_update": ops.fused_update,
            "rglru_scan": rglru_scan, "rglru_scan_bwd": rglru_scan_bwd,
            "flash_decode": flash_decode,
            "threefry_bits": tf.threefry_bits,
            "threefry_draws": tf.threefry_draws}


#: the threefry entries
THREEFRY = ("threefry_bits", "threefry_draws")
#: launches of each threefry entry in one closed-form round of the CNN (a
#: zone or the fleet's K zones): the zone's split, batch indices and both
#: keep masks in one ``threefry_draws``; no other entry
THREEFRY_PER_ROUND = {"threefry_draws": 1}
#: threefry launches (draws, bits) in one round of each baseline: a draws
#: launch per key block, and the key tree's splits and fold-ins
#: (``split(key, m)``, each client's split per step; Ditto's second block
#: from ``fold_in(key, 7)``; Per-FedAvg's split of each step's key)
BASELINE_THREEFRY = {"fedavg": (1, 2), "perfedavg": (1, 3), "pfedme": (1, 2),
                     "ditto": (2, 5), "apfl": (1, 2), "walkman": (1, 0)}
#: baselines whose evaluation draws (one launch a chunk of clients)
EVAL_DRAWS = ("perfedavg", "pfedme")
#: the update kernels, which the baselines never launch
UPDATES = ("zone_update", "multizone_update", "fused_update")


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def zero_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        counts = getattr(fn, "launches_by_path", None)
        if counts is not None:
            counts.update(dict.fromkeys(counts, 0))


def path_counts() -> dict:
    """Launches of the scan and of its backward by path: the ``staged`` or
    the ``loop`` kernel."""
    w = _wrappers()
    return {k: dict(w[k].launches_by_path)
            for k in ("rglru_scan", "rglru_scan_bwd")}


#: each model's seconds of ``init(seed)`` on the card (build and draw),
#: printed at the end
INIT_SECONDS: dict = {}


def note_init(label: str, seconds: float) -> float:
    INIT_SECONDS[label] = round(seconds, 2)
    return seconds


@contextlib.contextmanager
def counts_from_after_init():
    """Inside, each ``LM.init`` and ``EncDecLM.init`` sets the wrappers'
    counts to 0 as it returns: a run that builds and draws its own model
    (``serve.main``, the training driver, the federated example) counts
    its launches from after the draw, whose every split, fold-in and block
    of bits is a ``threefry_bits`` launch. Yields the list of each init's
    ``threefry_bits`` launches."""
    from repro_torch.models.transformer import LM
    from repro_torch.models.whisper import EncDecLM

    seen, originals = [], {cls: cls.init for cls in (LM, EncDecLM)}

    def counted(init):
        def run(self, seed=0):
            out = init(self, seed)
            seen.append(launch_counts()["threefry_bits"])
            zero_launch_counts()
            return out
        return run
    try:
        for cls, init in originals.items():
            cls.init = counted(init)
        yield seen
    finally:
        for cls, init in originals.items():
            cls.init = init


# ---------------------------------------------------------------------------
def phase_build() -> dict:
    """Build every kernel source with nvcc, one process per source, all
    started together; print what ptxas says of the kernels that ask it."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rwsadmm_update import ops as rw_ops
    from repro_torch.kernels.threefry import ops as tf_ops

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        libs = list(pool.map(lambda ops: ops.build(),
                             (rw_ops, rg_ops, fd_ops, tf_ops)))
    seconds = time.perf_counter() - t0
    entries = {}
    for lib in libs:
        entries.update(ptxas_entries(lib))
        for entry, info in ptxas_entries(lib).items():
            log(f"ptxas {lib.name.split('-')[0]}: {entry} {info}")
    log(f"build: 8 kernels from 4 sources in {seconds:.2f} s "
        f"({', '.join(l.name for l in libs)}); ptxas reports "
        f"{len(entries)} entries")
    return entries


def update_inputs(walkers: int, zone: int, n: int, live, seed: int, device):
    """Random multi-zone inputs on the card: x (K, Z, N), z, g, y (K, N),
    mask (K, Z) with ``live[k]`` live slots for walker k (0: an idle
    walker), κ. Walker 0's slot 0 has x = y (warm init, sgn(0))."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    x, z, g = (torch.randn(walkers, zone, n, generator=gen, device=device)
               for _ in range(3))
    y = torch.randn(walkers, n, generator=gen, device=device)
    z.mul_(0.01)
    x[0, 0] = y[0]
    mask = torch.zeros(walkers, zone, device=device)
    for k, n_live in enumerate(live):
        mask[k, :n_live] = 1.0
    kappa = torch.tensor([0.001], device=device)
    return x, z, y, g, mask, kappa


def agreement(x, z, y, mask, got, want) -> dict:
    """Kernel outputs ``got`` against the plain version's ``want``, all
    in multi-zone form (x/z (K, Z, N), y (K, N), mask (K, Z))."""
    import torch

    (xk, zk, yk), (xp, zp, yp) = got, want
    err = {k: float((a - b).abs().max()) for k, a, b in
           (("x", xk, xp), ("z", zk, zp), ("y", yk, yp))}
    live = (mask > 0).unsqueeze(-1)
    ref_y = y.unsqueeze(1)
    flip = ((torch.sign(ref_y - xk) != torch.sign(ref_y - xp))
            & live).any(dim=1)                             # (K, N)
    pad = ~live.expand_as(x)
    idle = mask.sum(dim=1) == 0
    row = {"err": err, "max_abs_err": max(err.values()),
           "sign_flips": int(flip.sum()),
           "padded_slots_exact": bool(torch.equal(xk[pad], x[pad])
                                      and torch.equal(zk[pad], z[pad])),
           "idle_walkers": int(idle.sum()),
           "idle_walkers_exact": bool(torch.equal(yk[idle], y[idle]))}
    row["ok"] = (row["padded_slots_exact"] and row["idle_walkers_exact"]
                 and all(torch.allclose(a, b, atol=KERNEL_TOL,
                                        rtol=KERNEL_TOL)
                         for a, b in ((xk, xp), (zk, zp)))
                 and torch.allclose(yk[~flip], yp[~flip], atol=KERNEL_TOL,
                                    rtol=KERNEL_TOL))
    return row


def as_multizone(kernel: str, x, z, y):
    """A kernel's (x, z, y) in multi-zone form: (K, Z, N), (K, Z, N),
    (K, N)."""
    if kernel == "zone_update":
        return x[None], z[None], y[None]
    if kernel == "fused_update":
        return x.view(1, 1, -1), z.view(1, 1, -1), y.view(1, -1)
    return x, z, y


def kernel_args(kernel: str, walkers: int, zone: int, n: int, live, seed: int,
                device):
    """One kernel's inputs, its plain version, the mask in multi-zone form
    and a shape label. ``zone_update`` takes walker 0's rows,
    ``fused_update`` walker 0's slot 0 (no mask)."""
    from repro_torch.kernels.rwsadmm_update import ref

    x, z, y, g, mask, kappa = update_inputs(walkers, zone, n, live, seed,
                                            device)
    if kernel == "multizone_update":
        return ((x, z, y, g, mask, kappa), ref.multizone_fused_update_ref,
                mask, f"K={walkers} Z={zone} N={n} live={list(live)}")
    if kernel == "zone_update":
        return ((x[0], z[0], y[0], g[0], mask[0], kappa),
                ref.zone_fused_update_ref, mask[:1],
                f"Z={zone} N={n} live={live[0]}")
    # x = y on the first quarter: warm init, sgn(0) = 0 there.
    x[0, 0, : n // 4] = y[0, : n // 4]
    return ((x[0, 0], z[0, 0], y[0], g[0, 0], kappa), ref.fused_update_ref,
            mask.new_ones(1, 1), f"N={n}")


# Input sets the timed rows rotate through, so that each call reads its
# inputs cold from HBM: the zone round reads 111 MB a set and the fleet's
# 333 MB, so two sets do; one client's update reads 17 MB, so six
# (103 MB) do, twice the 50 MB L2.
COLD_SETS = {"zone_update": 2, "multizone_update": 2, "fused_update": 6}


def time_update_kernel(kernel: str, plain, sets, kw: dict) -> dict:
    """Device time per call of one RWSADMM kernel and of its plain
    version: cold (rotating through ``sets``), warm (the first set again
    and again), CUDA-graph replay beside both."""
    launch = _wrappers()[kernel]
    reps = 60 // len(sets)
    cold = device_time_ms([lambda a=a: launch(*a, **kw) for a in sets], reps,
                          kernels=1)
    warm = device_time_ms([lambda: launch(*sets[0], **kw)], 60, kernels=1)
    plain_cold = device_time_ms([lambda a=a: plain(*a, **kw) for a in sets],
                                2, graph=False)
    plain_warm = device_time_ms([lambda: plain(*sets[0], **kw)], 4,
                                graph=False)
    return {"ms": cold["profiler"], "ms_warm": warm["profiler"],
            "graph_ms": cold["graph"], "graph_ms_warm": warm["graph"],
            "kernels_per_call": cold["kernels_per_call"],
            "plain_ms": plain_cold["profiler"],
            "plain_ms_warm": plain_warm["profiler"]}


def update_bound(kernel: str, zone: int, n: int, mask, card: str) -> dict:
    """The least time of one RWSADMM kernel call on these inputs."""
    if kernel == "fused_update":
        # Read x, z, y, g; write x⁺, z⁺, y⁺.
        bytes_moved, flops = 7 * n * 4, 30 * n
    else:
        # Per walker: read x, z (every slot), g (live slots only: a
        # padded slot's output is its input) and y; write x⁺, z⁺ and y⁺.
        # All slots live: K·(5Z + 2)·N·4 bytes.
        lives = [int(v) for v in mask.sum(dim=1).tolist()]
        bytes_moved = sum(4 * zone + n_live + 2 for n_live in lives) * n * 4
        flops = len(lives) * (34 * zone + 2) * n   # fp32 elementwise
    rate, rate_src = hbm_rate(card)
    bytes_ms = bytes_moved / rate * 1e3
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_rate=rate_src, bytes=bytes_moved)


def check_kernel(kernel: str, walkers: int, zone: int, n: int, live, hp,
                 device, card: str, time_it: bool,
                 n_total: int = MAIN["n_clients"]) -> dict:
    """One kernel against its plain version at one shape, with β and ε/2
    from ``hp`` and ``n_total`` clients, optionally timed by device time,
    cold and warm, beside its bound."""
    import torch

    seed = 97 * walkers + zone * 7 + n
    args, plain, mask, shape = kernel_args(kernel, walkers, zone, n, live,
                                           seed, device)
    kw = dict(beta=hp.beta, eps_half=hp.eps_half, n_total=float(n_total))
    got = _wrappers()[kernel](*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    row = agreement(*as_multizone(kernel, *args[:3]), mask,
                    as_multizone(kernel, *got), as_multizone(kernel, *want))
    row["shape"] = f"{shape} beta={hp.beta:g} n={n_total}"
    if time_it:
        sets = [args] + [kernel_args(kernel, walkers, zone, n, live,
                                     seed + i, device)[0]
                         for i in range(1, COLD_SETS[kernel])]
        row.update(time_update_kernel(kernel, plain, sets, kw))
        row.update(update_bound(kernel, zone, n, mask, card))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    log(f"kernel {kernel} {row['shape']}: max_abs_err {row['err']} "
        f"sign_flips {row['sign_flips']} padded_exact "
        f"{row['padded_slots_exact']} idle_walkers {row['idle_walkers']} "
        f"idle_exact {row['idle_walkers_exact']}"
        + (f" device ms cold {row['ms']:.5f} warm {row['ms_warm']:.5f} "
           f"graph cold {row['graph_ms']:.5f} warm {row['graph_ms_warm']:.5f}"
           f" plain device ms cold {row['plain_ms']:.4f} warm "
           f"{row['plain_ms_warm']:.4f} bound_ms {row['bound_ms']:.5f} "
           f"({row['bound_by']}, {row['bound_rate']}) share cold "
           f"{row['share_of_bound']:.3f}" if time_it else ""))
    if not row["ok"]:
        raise AssertionError(f"{kernel} disagrees with its plain version "
                             f"at {row['shape']}: {row}")
    return row


def table1_zones(device) -> list[dict]:
    """The zone kernel's calls on the Table 1 grid's ``rwsadmm_cf`` rows:
    per dataset and model, the trainer's width, zone, β, ε/2 and client
    count, and the live slot counts of its schedule over the grid's
    rounds (the host draws of ``run_simulation``'s seed 0)."""
    import numpy as np

    from benchmarks import table1_torch
    from repro_torch.models.small import get_model

    out = []
    for ds, (data, shape) in table1_torch.datasets(device).items():
        for name in table1_torch.MODELS:
            tr = table1_torch.make_trainer("rwsadmm_cf",
                                           get_model(name, shape), data,
                                           device=device)
            sched = tr.schedule(TABLE1_ROUNDS, np.random.default_rng(0))
            out.append({"cell": f"{ds}/{name}", "n": tr.layout.size,
                        "zone": tr.zone_size, "hp": tr.hp,
                        "n_clients": tr.n_clients,
                        "lives": sorted({int(v) for v in
                                         sched.mask.sum(axis=1)})})
    return out


def phase_kernels(hp, device, card: str) -> dict:
    """Every kernel at the paths' shapes; the first row of each is timed.
    The zone kernel is also held at every shape the Table 1 grid gives it
    (β = 10, 10 or 20 clients, each live count its schedules hold)."""
    z8 = MAIN["zone"]
    grid = [check_kernel("zone_update", 1, t["zone"], t["n"], (live,),
                         t["hp"], device, card, time_it=False,
                         n_total=t["n_clients"])
            for t in table1_zones(device) for live in t["lives"]]
    return {
        "zone_update": [
            check_kernel("zone_update", 1, z8, P_CNN, (z8,), hp, device,
                         card, time_it=True),
            check_kernel("zone_update", 1, z8, P_CNN, (6,), hp, device, card,
                         time_it=False),
            check_kernel("zone_update", 1, 3, 100_003, (2,), hp, device,
                         card, time_it=False)] + grid,
        "multizone_update": [
            check_kernel("multizone_update", 3, z8, P_CNN, (z8, z8, z8), hp,
                         device, card, time_it=True),
            check_kernel("multizone_update", 3, z8, P_CNN, (z8, 0, 5), hp,
                         device, card, time_it=False),
            check_kernel("multizone_update", 2, 3, 100_003, (1, 3), hp,
                         device, card, time_it=False)],
        "fused_update": [
            check_kernel("fused_update", 1, 1, P_CNN, (1,), hp, device, card,
                         time_it=True),
            check_kernel("fused_update", 1, 1, 100_003, (1,), hp, device,
                         card, time_it=False)],
    }


# ---------------------------------------------------------------------------
# threefry: the port of jax.random's sampler (no TPU kernel; XLA fuses the
# reference's draws into its compiled round).
#: 32-bit integer instructions of one threefry2x32 draw on sm_90a, as
#: ``scripts/threefry_sass.py`` counts them in the SASS: ``threefry_bits``
#: (a 64-bit counter's two words) 68: 20 rotates (SHF), 21 xors (LOP3) and
#: 27 adds (IADD3 on the ALU pipe, IMAD.IADD on the FMA pipe; a 3-input
#: IADD3 takes a key injection with the next round's add); ``draw`` in
#: ``threefry_draws`` (high word 0) 69 in the probe, of which the key's
#: k0 ^ k1 ^ C is made once for a thread's run of draws
HASH_OPS, DRAW_OPS = 68, 68
#: more integer operations a keep byte (the top 23 bits as a float in
#: [1, 2): shift, or, subtract, compare) and a batch index (two
#: remainders of its words, the multiply-add, the last remainder, ~10)
KEEP_OPS, INDEX_OPS = 4, 10
SPANS = (1, 7, 150, 600, 4999, 70_000, 2**31 - 1, 0)
#: output sets a cold timing rotates through: more than the 50 MB L2
COLD_BYTES = 64e6


def draws_work(leaves: int, batch: int, masks, fan: bool) -> tuple:
    """Bytes and integer operations one ``threefry_draws`` call must
    spend: it reads the parent keys and each leaf's client and span and
    writes the indices (int64) and keep bytes; each keep byte is one draw
    and a compare, each index two draws and ~10 operations, and each leaf
    hashes its key (with a fan-out), split's two halves and one fold-in a
    mask."""
    n_mask = leaves * sum(math.prod(m.shape) for m in masks)
    n_idx = leaves * batch
    parents = 1 if fan else leaves
    bytes_moved = 16 * parents + 16 * leaves + 8 * n_idx + n_mask
    key_hashes = leaves * (int(fan) + 2 + len(masks))
    ops = (n_mask * (DRAW_OPS + KEEP_OPS) + n_idx * (2 * DRAW_OPS + INDEX_OPS)
           + key_hashes * DRAW_OPS)
    return bytes_moved, ops, n_mask, n_idx


def bound(bytes_moved: int, ops: int, card: str) -> dict:
    """The least time for the work: bytes at the memory rate, 32-bit
    integer instructions at the SM's issue rate."""
    rate, rate_src = hbm_rate(card)
    irate, irate_src = int32_rate()
    bytes_ms, ops_ms = bytes_moved / rate * 1e3, ops / irate * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_rate": f"{rate_src}; {irate_src}",
            "bytes": bytes_moved, "ops": ops}


def threefry_cases(key, keys, n_train, masks, batch, device):
    """``threefry_draws`` and ``threefry_bits`` calls as (label, kernel
    call, plain call), each giving a tuple of tensors: the zone's and the
    fleet's round (the split in the launch), prox-SGD's step-major tree,
    the edge spans without a client table, the one-output form
    ``bernoulli`` takes, and split, fold-in and raw-bits calls of
    ``threefry_bits``."""
    import torch

    from repro_torch.kernels.threefry import ops as tf
    from repro_torch.kernels.threefry import ref

    def draws(label, src, **kw):
        def run(fn):
            idx, outs = fn(src, **kw)
            return (idx, *outs)
        return label, lambda: run(tf.threefry_draws), \
            lambda: run(ref.draws_ref)

    zone = keys.shape[0]
    n_conv = math.prod(masks[0].shape)
    clients = {z: torch.arange(z, device=device) % n_train.shape[0]
               for z in (zone, 3 * zone)}
    spans = torch.tensor(SPANS, device=device)
    return [
        *(draws(f"round, {z} leaves", key, split=z, batch=batch,
                spans=n_train, clients=clients[z], masks=masks)
          for z in (zone, 3 * zone)),
        draws("prox-SGD, 3 steps", keys, split=3, batch=batch, spans=n_train,
              clients=clients[zone], masks=masks),
        draws("edge spans", keys, batch=batch, spans=spans, masks=masks),
        draws("edge spans, minval 3", keys, batch=batch, spans=spans,
              minval=3),
        draws("bernoulli", keys, masks=(ref.MaskSpec((n_conv,), 0.75),),
              fold=False),
        ("split", lambda: (tf.threefry_bits(key, zone, pair=True),),
         lambda: (ref.bits_ref(key, zone, 0, True),)),
        ("fold_in", lambda: (tf.threefry_bits(keys, 1, offset=7,
                                              pair=True),),
         lambda: (ref.bits_ref(keys, 1, 7, True),)),
        ("bits", lambda: (tf.threefry_bits(keys, n_conv),),
         lambda: (ref.bits_ref(keys, n_conv),))]


def time_draws(key, kw: dict, leaves: int, card: str, plain: bool) -> dict:
    """One round's ``threefry_draws`` by device time, cold (output sets
    rotating through more than the L2, each kept until its turn comes
    again) and warm (one set), beside its bound; the plain version's
    time with ``plain``."""
    from repro_torch.kernels.threefry import ops as tf
    from repro_torch.kernels.threefry import ref

    masks = kw["masks"]
    bytes_moved, ops, n_mask, n_idx = draws_work(leaves, kw["batch"], masks,
                                                 True)
    sets = math.ceil(COLD_BYTES / (n_mask + 8 * n_idx))
    held = [None] * sets

    def call(i):
        def fn():
            held[i] = tf.threefry_draws(key, **kw)
        return fn
    cold = device_time_ms([call(i) for i in range(sets)], 4, kernels=1)
    warm = device_time_ms([call(0)], 50, kernels=1)
    out = {"ms": cold["profiler"], "ms_warm": warm["profiler"],
           "graph_ms": cold["graph"], "graph_ms_warm": warm["graph"],
           "kernels_per_call": warm["kernels_per_call"], "cold_sets": sets,
           "n_mask": n_mask, "n_idx": n_idx, "library_ms": None,
           **bound(bytes_moved, ops, card)}
    if plain:
        p = device_time_ms([lambda: ref.draws_ref(key, **kw)], 3,
                           graph=False)
        out.update(plain_ms=p["profiler"],
                   plain_kernels_per_call=p["kernels_per_call"])
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    return out


def phase_threefry(device, model, data, card: str) -> dict:
    """``threefry_draws`` and ``threefry_bits`` bit for bit against the
    plain integer ops (``kernels/threefry/ref.py``, run on the card) at
    the CNN's shapes; then one zone round's draws (8 leaves) and one
    fleet step's (24) timed cold and warm beside their bound and the
    plain version's time, and a cohort's key split (10 clients × 10
    steps) for ``threefry_bits``."""
    import torch

    from repro_torch.core import prng
    from repro_torch.kernels.threefry import ops as tf
    from repro_torch.kernels.threefry import ref

    batch, zone = MAIN["batch"], MAIN["zone"]
    masks = model.keep_masks(batch)
    key = prng.prng_key(1000, device)[None]
    keys = prng.split(key[0], zone)
    errs = {}
    for label, kernel, plain in threefry_cases(key, keys, data.n_train,
                                               masks, batch, device):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if len(got) != len(want) or not all(
                g.shape == w.shape and torch.equal(g, w)
                for g, w in zip(got, want)):
            raise AssertionError(f"threefry {label} differs from its plain "
                                 "version")
        errs[label] = max((float((g.long() - w.long()).abs().max())
                           for g, w in zip(got, want) if g.numel()),
                          default=0.0)
    log(f"kernel threefry: threefry_draws and threefry_bits bitwise equal to "
        f"their plain versions at masks {[list(m.shape) for m in masks]}, "
        f"batch {batch} (max_abs_err {errs})")

    rows = {}
    for leaves in (zone, 3 * zone):
        clients = torch.arange(leaves, device=device) % data.n_clients
        kw = dict(split=leaves, batch=batch, spans=data.n_train,
                  clients=clients, masks=masks)
        row = time_draws(key, kw, leaves, card, plain=leaves == zone)
        row["shape"] = (f"{leaves} leaves from one key, batch {batch}, "
                        f"masks {[list(m.shape) for m in masks]}")
        row["max_abs_err"] = max(errs.values())
        rows[leaves] = row
        log(f"kernel threefry_draws, {leaves} leaves ({row['n_idx']} "
            f"indices, {row['n_mask']:,} keep bytes): device ms "
            f"{row['ms']:.5f} cold ({row['cold_sets']} output sets), "
            f"{row['ms_warm']:.5f} warm, in {row['kernels_per_call']:.0f} "
            f"launch(es); graph {row['graph_ms']:.5f} cold, "
            f"{row['graph_ms_warm']:.5f} warm"
            + (f"; plain device ms {row['plain_ms']:.4f} in "
               f"{row['plain_kernels_per_call']:.0f} kernels"
               if "plain_ms" in row else "")
            + f"; bound_ms {row['bound_ms']:.5f} ({row['bound_by']}: "
            f"{row['bytes']:,} bytes, {row['ops']:,} operations; "
            f"{row['bound_rate']}) share {row['share_of_bound']:.3f}")
    draws = [rows[zone], rows[3 * zone]]
    draws[1]["plain_ms"] = None

    cohort = prng.split(key[0], 10)
    n_pairs = 10 * 10
    timed = device_time_ms([lambda: tf.threefry_bits(cohort, 10, pair=True)],
                           50, kernels=1)
    plain = device_time_ms([lambda: ref.bits_ref(cohort, 10, 0, True)], 3,
                           graph=False)
    bits = {"shape": "10 keys × 10 counters, word pairs (a cohort's split "
                     "per step)",
            "ms": timed["profiler"], "graph_ms": timed["graph"],
            "plain_ms": plain["profiler"], "library_ms": None,
            "max_abs_err": 0.0,
            **bound(16 * 10 + 16 * n_pairs, n_pairs * HASH_OPS, card)}
    bits["share_of_bound"] = bits["bound_ms"] / bits["ms"]
    log(f"kernel threefry_bits, {bits['shape']}: device ms "
        f"{bits['ms']:.5f} (1.8 KB: the L2's state does not matter), graph "
        f"{bits['graph_ms']:.5f}; plain {bits['plain_ms']:.4f}; bound_ms "
        f"{bits['bound_ms']:.6f} ({bits['bound_by']}) share "
        f"{bits['share_of_bound']:.3f}")
    return {"threefry_draws": draws, "threefry_bits": [bits]}


# ---------------------------------------------------------------------------
# LM weights at a seed: ``init(seed)`` walks the reference's key tree with
# ``core/prng.py`` on the model's device (every split, fold-in and block of
# bits a ``threefry_bits`` launch on the card, the plain integer ops on the
# CPU).
#: the largest gap, in fp32 ulp, between two draws of one normal: the
#: bits are exact, erf⁻¹'s log1p and sqrt may round otherwise on the card
#: (``tests/test_torch_privacy.py``)
NORMAL_ULP = 4
#: the family each reduced config holds the init of
INIT_FAMILIES = {"gemma3-12b": "attention (local, tied)",
                 "kimi-k2-1t-a32b": "MoE with a shared expert",
                 "qwen2-7b": "attention (qkv bias)",
                 "qwen2-vl-2b": "attention, vision projector",
                 "qwen3-moe-30b-a3b": "MoE",
                 "recurrentgemma-9b": "RG-LRU and local attention",
                 "tinyllama-1.1b": "attention", "whisper-large-v3":
                     "encoder-decoder", "xlstm-350m": "mLSTM and sLSTM",
                 "yi-34b": "attention"}


def ulp_gap(got, want) -> int:
    """The largest gap of two fp32 tensors in units in the last place."""
    import torch

    ia, ib = (t.detach().cpu().float().contiguous().view(torch.int32)
              .to(torch.int64) for t in (got, want))
    return int((ia - ib).abs().max()) if ia.numel() else 0


def phase_lm_init(device, card: str) -> dict:
    """Each registered config's ``reduced()`` (fp32) ``init(seed)`` on the
    card against the same on the CPU, leaf by leaf: within ``NORMAL_ULP``,
    and constant leaves (norms, biases, λ) exactly; the init's launches
    (``threefry_bits`` only). Then ``threefry_bits`` timed at the init's
    block, ``prng.NORMAL_BLOCK`` draws under one key, cold and warm beside
    its bound and the plain integer ops."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels.threefry import ops as tf
    from repro_torch.kernels.threefry import ref
    from repro_torch.models.registry import build_model

    rows = {}
    for arch, family in INIT_FAMILIES.items():
        cfg = get_config(arch).reduced()
        zero_launch_counts()
        t0 = time.perf_counter()
        card_model = build_model(cfg, device=device).init(SERVE["seed"])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counts = launch_counts()
        t0 = time.perf_counter()
        want = build_model(cfg, device="cpu").init(SERVE["seed"]).state_dict()
        cpu_s = time.perf_counter() - t0
        got = card_model.state_dict()
        gaps = {k: ulp_gap(got[k], w) for k, w in want.items()}
        const = [k for k, w in want.items()
                 if bool((w == w.reshape(-1)[0]).all())]
        row = {"family": family, "values": sum(w.numel()
                                               for w in want.values()),
               "leaves": len(want), "max_ulp": max(gaps.values()),
               "constant_leaves": len(const),
               "constant_exact": all(torch.equal(got[k].cpu(), want[k])
                                     for k in const),
               "card_s": card_s, "cpu_s": cpu_s, "launches": counts}
        rows[arch] = row
        log(f"lm init: {arch} ({family}) reduced, {row['values']:,} values "
            f"in {row['leaves']} leaves at seed {SERVE['seed']}: card vs CPU "
            f"max {row['max_ulp']} ulp (bound {NORMAL_ULP}), "
            f"{len(const)} constant leaves exact {row['constant_exact']}; "
            f"card {card_s:.3f} s in {counts['threefry_bits']} threefry_bits "
            f"launches, CPU {cpu_s:.2f} s")
        others = {k: v for k, v in counts.items() if k != "threefry_bits"}
        if (set(got) != set(want) or row["max_ulp"] > NORMAL_ULP
                or not row["constant_exact"] or any(others.values())
                or not counts["threefry_bits"]):
            raise AssertionError(f"lm init {arch}: card vs CPU {row}")
        del card_model, want, got

    # threefry_bits at the init's block: NORMAL_BLOCK draws (8 bytes each
    # written) under one key, HASH_OPS integer instructions a draw
    n = prng.NORMAL_BLOCK
    key = prng.prng_key(SERVE["seed"], device)[None]
    sets = math.ceil(COLD_BYTES / (8 * n))
    held = [None] * sets

    def call(i):
        def fn():
            held[i] = tf.threefry_bits(key, n, offset=i * n)
        return fn
    got = tf.threefry_bits(key, n, offset=n)
    torch.cuda.synchronize()
    err = float((got - ref.bits_ref(key, n, n)).abs().max())
    cold = device_time_ms([call(i) for i in range(sets)], 5, kernels=1)
    warm = device_time_ms([call(0)], 20, kernels=1)
    plain = device_time_ms([lambda: ref.bits_ref(key, n, n)], 2, graph=False)
    block = {"shape": f"1 key × {n:,} counters, 32-bit draws (the init's "
                      f"block)",
             "ms": cold["profiler"], "ms_warm": warm["profiler"],
             "graph_ms": cold["graph"], "graph_ms_warm": warm["graph"],
             "plain_ms": plain["profiler"], "library_ms": None,
             "max_abs_err": err, "cold_sets": sets,
             **bound(16 + 8 * n, n * HASH_OPS, card)}
    block["share_of_bound"] = block["bound_ms"] / block["ms"]
    log(f"kernel threefry_bits, {block['shape']}: max_abs_err {err}; device "
        f"ms {block['ms']:.5f} cold ({sets} output sets), "
        f"{block['ms_warm']:.5f} warm; graph {block['graph_ms']:.5f} cold, "
        f"{block['graph_ms_warm']:.5f} warm; plain {block['plain_ms']:.3f}; "
        f"bound_ms {block['bound_ms']:.5f} ({block['bound_by']}: "
        f"{block['bytes']:,} bytes, {block['ops']:,} operations; "
        f"{block['bound_rate']}) share {block['share_of_bound']:.3f}")
    if err != 0.0:
        raise AssertionError(f"threefry_bits at the init's block differs "
                             f"from its plain version: {err}")
    del held, got
    return {"inits": rows, "threefry_bits_init_block": block}


# ---------------------------------------------------------------------------
def build_main_path(device, seed: int):
    from repro_torch.core.rwsadmm import RWSADMMHparams
    from repro_torch.data import build_federated, pathological_split
    from repro_torch.data.synthetic_images import make_cifar_like
    from repro_torch.fl.base import to_device_data
    from repro_torch.models.small import CNN

    t0 = time.perf_counter()
    imgs, labels = make_cifar_like(MAIN["n_samples"], seed=seed)
    parts = pathological_split(labels, MAIN["n_clients"], seed=seed)
    data = to_device_data(build_federated(imgs, labels, parts), device)
    model = CNN((32, 32, 3))   # c1=16, c2=32, fc=512: the paper's widths
    # β = 100 departs from the paper's β = 10 (docs/algorithm.md): at
    # β = 10 the closed-form step diverges on this make_cifar_like
    # stand-in in both packages (tests/test_torch_beta_probe.py, PERF.md).
    hp = RWSADMMHparams(beta=100.0)
    log(f"data: {MAIN['n_samples']} CIFAR-shaped samples over "
        f"{MAIN['n_clients']} clients, x_train {tuple(data.x_train.shape)} "
        f"in {time.perf_counter() - t0:.2f} s")
    return model, data, hp


def make_trainer(model, data, hp, device, seed, scenario=None, **kw):
    from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer

    return RWSADMMTrainer(model, data, hp, batch_size=MAIN["batch"],
                          zone_size=MAIN["zone"], solver="closed_form",
                          scenario=scenario, seed=seed, device=device, **kw)


def make_fleet(model, data, hp, device, seed, mode="simultaneous",
               scenario=None, **kw):
    from repro_torch.fl.fleet_trainer import FleetRWSADMMTrainer

    return FleetRWSADMMTrainer(
        model, data, hp, n_walkers=FLEET["n_walkers"],
        sync_every=FLEET["sync_every"], fleet_mode=mode,
        batch_size=MAIN["batch"], zone_size=MAIN["zone"],
        solver="closed_form", scenario=scenario, seed=seed, device=device,
        **kw)


def check_run(res, rounds: int, label: str) -> tuple[list, float]:
    """Finite losses for every round, a finite personalized accuracy and
    round metrics that follow the schema."""
    from repro_torch.fl.base import validate_round_metrics

    validate_round_metrics(res.round_metrics)
    losses = [m["train_loss"] for m in res.round_metrics]
    if len(losses) != rounds or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: non-finite or missing losses: "
                             f"{losses}")
    acc = res.final.get("acc_personalized")
    if acc is None or not math.isfinite(acc):
        raise AssertionError(f"{label}: no personalized accuracy: "
                             f"{res.final}")
    return losses, acc


def window_launches(trainer) -> dict:
    """Kernel launches that a trainer's captured windows ran: each
    window's warm-up round, plus its captured launches once per replay
    (the wrappers count a capture once and do not see replays)."""
    out: dict[str, int] = {}
    for win in trainer.windows.values():
        for k, n in win.captured.items():
            out[k] = out.get(k, 0) + win.warmup[k] + win.replays * n
    return out


def drive(trainer, rounds: int, seed: int, update: str, label: str,
          window: int | None = None, telemetry=None):
    """One ``run_simulation`` of ``scan_fused`` on a fresh trainer, in
    windows of ``window`` rounds (one window without), with every launch
    count set to 0 just before and read just after. The wrappers' counts
    must be the windows' warm-up rounds and captures, and what the
    replays ran must be one ``update`` launch and one ``threefry_draws``
    launch per round (warm-up rounds included), and no other kernel's."""
    import torch

    from repro_torch.fl.simulation import run_simulation

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    res = run_simulation(trainer, rounds=rounds, eval_every=window or rounds,
                         seed=seed, engine="scan_fused", telemetry=telemetry)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    wins = trainer.windows.values()
    recorded = {k: sum(w.warmup.get(k, 0) + w.captured.get(k, 0)
                       for w in wins) for k in counts}
    ran = window_launches(trainer)
    per_round = {update: 1, **THREEFRY_PER_ROUND}
    warm = len(trainer.windows)
    want = {k: n * (rounds + warm) for k, n in per_round.items()}
    if counts != recorded or {k: ran.get(k, 0) for k in want} != want \
            or any(counts[k] for k in counts if k not in per_round):
        raise AssertionError(f"{label}: wrapper counts {counts} (captures "
                             f"and warm-ups {recorded}), launches run {ran} "
                             f"(want {want})")
    losses, acc = check_run(res, rounds, label)
    return res, {"counts": counts, "ran": ran,
                 "replays": sum(w.replays for w in wins),
                 "captured_per_window": [w.captured for w in wins]}, \
        peak, losses, acc


def phase_main_path(device, model, data, hp) -> dict:
    from repro_torch.fl.simulation import run_simulation

    seed = MAIN["seed"]
    trainer = make_trainer(model, data, hp, device, seed)
    log(f"model: cnn (32, 32, 3) P = {trainer.layout.size:,} "
        f"({trainer.params_bytes() / 1e6:.2f} MB fp32)")

    # Warm-up (cuDNN plans, allocator) on a throwaway trainer.
    run_simulation(make_trainer(model, data, hp, device, seed + 1),
                   rounds=3, eval_every=3, seed=seed + 1,
                   engine="scan_fused")
    rounds = MAIN["rounds"]
    res, counts, peak, losses, acc = drive(
        trainer, rounds, seed, "zone_update", "single-walker path")
    log(f"main path: {rounds} rounds scan_fused in {res.wall_time_s:.3f} s "
        f"= {rounds / res.wall_time_s:.2f} rounds/s (one eval, the warm-up "
        f"round and the window's capture included), peak allocated "
        f"{peak / 2**30:.3f} GiB, wrapper counts {counts['counts']}, "
        f"launches run {counts['ran']} in {counts['replays']} graph "
        f"replay(s), loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"acc_personalized "
        f"{acc:.4f} ± {res.final['acc_personalized_std']:.4f}, acc_global "
        f"{res.final['acc_global']:.4f}")
    steady = time_steady_rounds(trainer, "round")
    lock = compare_lockstep(
        lambda: make_trainer(model, data, hp, device, seed),
        MAIN["eager_rounds"],
        lambda s: {"x": s.clients.x, "z": s.clients.z,
                   "y": s.server.y, "kappa": s.server.kappa},
        "rounds", hp, "single walker")
    return {"launches": counts["counts"], "launches_run": counts["ran"],
            "graph_replays": counts["replays"],
            "rounds_per_s": rounds / res.wall_time_s,
            "peak_gib": peak / 2**30, "acc_personalized": acc,
            "lockstep": lockstep_summary(lock), **steady}


def phase_fleet(device, model, data, hp) -> dict:
    """The K = 3 simultaneous fleet on the full-width CNN, then a
    round-robin fleet on the zone kernel."""
    from repro_torch.fl.simulation import run_simulation

    seed = MAIN["seed"]
    k = FLEET["n_walkers"]
    run_simulation(make_fleet(model, data, hp, device, seed + 1),
                   rounds=3, eval_every=3, seed=seed + 1,
                   engine="scan_fused")                  # warm-up
    fleet = make_fleet(model, data, hp, device, seed)
    steps = FLEET["wall_steps"]
    res, counts, peak, losses, acc = drive(
        fleet, steps, seed, "multizone_update", "fleet path")
    zones = [m["zone"] for m in res.round_metrics]
    log(f"fleet path: K={k} simultaneous, sync_every {FLEET['sync_every']}, "
        f"{steps} wall steps scan_fused in {res.wall_time_s:.3f} s = "
        f"{steps / res.wall_time_s:.2f} wall steps/s "
        f"({sum(zones) / res.wall_time_s:.1f} client updates/s; one eval "
        f"included), peak allocated {peak / 2**30:.3f} GiB, wrapper counts "
        f"{counts['counts']}, launches run {counts['ran']} in "
        f"{counts['replays']} graph replay(s), live slots per step "
        f"{min(zones)}..{max(zones)} of "
        f"{k * MAIN['zone']}, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"acc_personalized {acc:.4f} ± "
        f"{res.final['acc_personalized_std']:.4f}, acc_global "
        f"{res.final['acc_global']:.4f}, fleet hitting time "
        f"{fleet.fleet_hitting_time()}")
    steady = time_steady_rounds(fleet, "wall step")
    lock = compare_lockstep(
        lambda: make_fleet(model, data, hp, device, seed),
        FLEET["eager_steps"],
        lambda s: {"x": s.base.clients.x, "z": s.base.clients.z,
                   "tokens": s.tokens, "kappa": s.base.server.kappa},
        "wall steps", hp, "fleet simultaneous")

    rr = make_fleet(model, data, hp, device, seed, mode="roundrobin")
    rounds = FLEET["rr_rounds"]
    rr_res, rr_counts, _, rr_losses, rr_acc = drive(
        rr, rounds, seed, "zone_update", "round-robin fleet")
    log(f"round-robin fleet: K={k}, {rounds} rounds scan_fused in "
        f"{rr_res.wall_time_s:.3f} s, launches run {rr_counts['ran']}, loss "
        f"{rr_losses[0]:.4f} -> {rr_losses[-1]:.4f}, acc_personalized "
        f"{rr_acc:.4f}")
    return {"launches": counts["counts"], "launches_run": counts["ran"],
            "graph_replays": counts["replays"],
            "wall_steps_per_s": steps / res.wall_time_s,
            "client_updates_per_s": sum(zones) / res.wall_time_s,
            "peak_gib": peak / 2**30, "acc_personalized": acc,
            "rr_launches_run": rr_counts["ran"],
            "lockstep": lockstep_summary(lock), **steady}


# ---------------------------------------------------------------------------
# Scenarios: the paper's infrastructure-less field (mobility, lossy links,
# churn) on the main path's CNN and data.
SCENARIOS = dict(single="field_trial", fleet="lossy_links",
                 cohort="duty_cycle", cohort_rounds=5, schedule_windows=5)
#: the columns a schedule decides on the host, held by ``==``
HOST_COLUMNS = ("client", "clients", "zone", "n_i", "latency_s", "energy_j",
                "staleness_p50", "staleness_max", "comm_bytes")


def host_columns(metrics: list) -> dict:
    return {k: [m.get(k) for m in metrics] for k in HOST_COLUMNS}


def walk_weights(trainer) -> list:
    """Every walker's ``weight_history`` (the fleet's walkers, or the
    single walker)."""
    return [list(w.weight_history)
            for w in getattr(trainer, "walkers", None) or [trainer.walker]]


def hold_host_columns(res, make, make_cpu, rounds: int, label: str,
                      trainer=None, eager_walks: bool = True):
    """The ``scan_fused`` run's host columns against an eager run from the
    same seed on the card and against the same trainer's ``schedule()``
    on the CPU: equal by ``==``. Under a biased policy (``trainer`` the
    ``scan_fused`` run's) the importance weights too: every walker's
    ``weight_history`` and the CPU schedule's ``iw`` column. Without
    ``eager_walks`` (``batched_walk``, whose eager rounds walk another
    stream) the eager run is left out. Returns the CPU schedule."""
    import numpy as np
    import torch

    from repro_torch.fl.simulation import run_simulation

    seed = MAIN["seed"]
    runs = {"scan_fused": res.round_metrics}
    trainers = {"scan_fused": trainer}
    if eager_walks:
        trainers["eager"] = make()
        runs["eager"] = run_simulation(trainers["eager"], rounds=rounds,
                                       eval_every=rounds, seed=seed,
                                       engine="eager").round_metrics
    cpu = trainers["cpu schedule"] = make_cpu()
    sched = cpu.schedule(rounds, np.random.default_rng(seed))
    zeros = torch.zeros(rounds)
    runs["cpu schedule"] = cpu.chunk_round_metrics(
        sched, {"train_loss": zeros, "kappa": zeros}, 0)
    cols = {k: host_columns(v) for k, v in runs.items()}
    first = cols["scan_fused"]
    equal = all(c == first for c in cols.values())
    iw = "no iw column"
    if sched.iw is not None:
        weights = {k: walk_weights(t) for k, t in trainers.items()}
        iw_col = np.asarray(weights["cpu schedule"]).T.reshape(
            sched.iw.shape)
        iw_equal = (all(w == weights["cpu schedule"]
                        for w in weights.values())
                    and np.array_equal(sched.iw, iw_col))
        equal = equal and iw_equal
        iw = (f"iw and weight_history equal {iw_equal} (iw "
              f"{sched.iw.min():.4f}..{sched.iw.max():.4f})")
    log(f"{label}: host columns {', '.join(HOST_COLUMNS)} over {rounds} "
        f"rounds equal by == across {', '.join(cols)}: {equal}; {iw}; "
        f"latency {res.total_latency_s:.4f} s, energy "
        f"{res.total_energy_j:.4f} J in total")
    if not equal or res.total_latency_s <= 0 or res.total_energy_j <= 0:
        diff = {k: [c[k] for c in cols.values()] for k in HOST_COLUMNS
                if any(c[k] != first[k] for c in cols.values())}
        raise AssertionError(f"{label}: host columns differ: {diff}")
    return sched


def dead_share(sched) -> float:
    """Padded (dead) slots of a schedule's masks, as a share."""
    return float(1.0 - sched.mask.sum() / sched.mask.size)


def schedule_ms(make_cpu, rounds: int) -> float:
    """Median host ms of one ``schedule()`` window, windows in turn."""
    import numpy as np

    tr, rng, times = make_cpu(), np.random.default_rng(0), []
    for k in range(SCENARIOS["schedule_windows"]):
        t0 = time.perf_counter()
        tr.schedule(rounds, rng, start_round=k * rounds)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def cohort_under_churn(device, model, data) -> dict:
    """FedAvg under ``duty_cycle`` on the CNN: each cohort drawn from the
    clients awake that round, each round priced at the base station
    (both against a replay of the scenario's positions-only lane), no
    update kernel launched and the draws through threefry as counted."""
    import numpy as np
    import torch

    from repro_torch.fl.simulation import run_simulation
    from repro_torch.scenarios import Scenario

    seed, rounds = MAIN["seed"], SCENARIOS["cohort_rounds"]
    fed = make_baseline("fedavg", model, data, device,
                        clients_per_round=CNN_BASELINES["clients_per_round"],
                        lr=CNN_BASELINES["lr"])
    cohorts = record_cohorts(fed)
    torch.cuda.synchronize()
    zero_launch_counts()
    res = run_simulation(fed, rounds=rounds, eval_every=rounds, seed=seed,
                         scenario=SCENARIOS["cohort"])
    torch.cuda.synchronize()
    counts = launch_counts()
    want = want_threefry("fedavg", rounds, 1, fed.n_clients)
    scn = Scenario(fed.n_clients, SCENARIOS["cohort"], seed=seed,
                   positions_only=True)
    awake, priced = [], []
    for r, (cohort, m) in enumerate(zip(cohorts, res.round_metrics)):
        if r:
            scn.step()
        pool = np.flatnonzero(scn.availability())
        awake.append(len(pool) >= fed.m and set(cohort) <= set(pool))
        priced.append((m["latency_s"], m["energy_j"]) == scn.price_star_round(
            np.asarray(cohort), fed.params_bytes()))
    ok = (all(awake) and all(priced) and len(cohorts) == rounds
          and final_losses_finite(res)
          and not any(counts[k] for k in UPDATES)
          and {k: counts[k] for k in want} == want)
    log(f"fedavg under {SCENARIOS['cohort']}: {rounds} rounds, cohorts "
        f"from awake clients {all(awake)}, star prices equal the replay's "
        f"{all(priced)} (latency {res.total_latency_s:.4f} s, energy "
        f"{res.total_energy_j:.4f} J), update launches "
        f"{ {k: counts[k] for k in UPDATES} }, threefry "
        f"{ {k: counts[k] for k in THREEFRY} } (want {want}), final "
        f"{res.final}")
    if not ok:
        raise AssertionError(f"fedavg under {SCENARIOS['cohort']}: awake "
                             f"{awake}, priced {priced}, counts {counts}")
    return {"rounds": rounds, "latency_s": res.total_latency_s,
            "energy_j": res.total_energy_j, "threefry": want}


def phase_scenarios(device, model, data, hp, static: dict) -> dict:
    """The single walker under ``field_trial`` and the K = 3 simultaneous
    fleet under ``lossy_links``, each driven once through
    ``run_simulation`` (launch counts exact per round), its host columns
    held against eager and the CPU's schedule, eager and the fused rounds
    in lockstep (:func:`compare_lockstep`), its captured windows bit for
    bit;
    steady times beside the ``static_regen`` runs of this call
    (``static``), ``schedule()``'s host time and the masks' dead-slot
    share; FedAvg under ``duty_cycle``; the scenario sweep's smoke."""
    import numpy as np
    import torch

    from benchmarks import scenario_sweep_torch
    from repro_torch.fl.base import DeviceData

    seed, rounds = MAIN["seed"], MAIN["rounds"]
    cpu_data = DeviceData(*(t.cpu() for t in data))
    out = {}
    for label, mode, scenario, update, steps in (
            ("single walker", None, SCENARIOS["single"], "zone_update",
             rounds),
            ("fleet simultaneous", "simultaneous", SCENARIOS["fleet"],
             "multizone_update", FLEET["wall_steps"])):
        def make(dev=device, dat=data, mode=mode, scenario=scenario):
            if mode is None:
                return make_trainer(model, dat, hp, dev, seed, scenario)
            return make_fleet(model, dat, hp, dev, seed, mode, scenario)

        def make_cpu(make=make):
            return make("cpu", cpu_data)

        def make_static(mode=mode, dev="cpu", dat=cpu_data):
            if mode is None:
                return make_trainer(model, dat, hp, dev, seed)
            return make_fleet(model, dat, hp, dev, seed, mode)

        tag = f"scenarios, {label} under {scenario}"
        trainer = make()
        res, counts, peak, losses, acc = drive(trainer, steps, seed, update,
                                               tag)
        sched = hold_host_columns(res, make, make_cpu, steps, tag)
        static_sched = make_static().schedule(steps,
                                              np.random.default_rng(seed))
        lock = compare_lockstep(
            make, FLEET["eager_steps"] if mode else MAIN["eager_rounds"],
            lambda st: {k: v for k, v in state_leaves(st).items()
                        if k != "visited"},
            "wall steps" if mode else "rounds", hp, tag)
        steady = time_steady_rounds(trainer, "wall step" if mode else "round")
        sched_ms = {"scenario": schedule_ms(make_cpu, steps),
                    "static_regen": schedule_ms(make_static, steps)}
        dead = {"scenario": dead_share(sched),
                "static_regen": dead_share(static_sched)}
        base = static["fleet_path" if mode else "main_path"]
        unit = "wall step" if mode else "round"
        log(f"{tag}: {steps} {unit}s scan_fused, wrapper counts "
            f"{counts['counts']}, launches run {counts['ran']} in "
            f"{counts['replays']} graph replay(s), loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, acc_personalized {acc:.4f}; steady "
            f"scan_fused {steady['scan_fused_round_ms']:.3f} ms/{unit} "
            f"against static_regen's {base['scan_fused_round_ms']:.3f} "
            f"in this call (scan {steady['scan_round_ms']:.3f} against "
            f"{base['scan_round_ms']:.3f}, eager "
            f"{steady['eager_round_ms']:.3f} against "
            f"{base['eager_round_ms']:.3f}), busy share "
            f"{steady['busy_share']:.3f} against {base['busy_share']:.3f}; "
            f"host schedule() of a {steps}-{unit} window "
            f"{sched_ms['scenario']:.2f} ms against static_regen's "
            f"{sched_ms['static_regen']:.2f} ms; dead slots "
            f"{dead['scenario']:.3f} of the masks against static_regen's "
            f"{dead['static_regen']:.3f}; peak {peak / 2**30:.3f} GiB")
        out[label] = {"scenario": scenario, "launches": counts["counts"],
                      "launches_run": counts["ran"],
                      "graph_replays": counts["replays"],
                      "acc_personalized": acc,
                      "latency_s": res.total_latency_s,
                      "energy_j": res.total_energy_j,
                      "schedule_ms": sched_ms, "dead_share": dead,
                      "static_regen_round_ms": base["scan_fused_round_ms"],
                      "lockstep": lockstep_summary(lock), **steady}
        del trainer
        torch.cuda.empty_cache()
    out["capture"] = check_captures({
        f"single walker under {SCENARIOS['single']}":
            lambda: make_trainer(model, data, hp, device, seed,
                                 SCENARIOS["single"]),
        f"fleet simultaneous under {SCENARIOS['fleet']}":
            lambda: make_fleet(model, data, hp, device, seed,
                               scenario=SCENARIOS["fleet"])})
    out["fedavg"] = cohort_under_churn(device, model, data)
    t0 = time.perf_counter()
    # Speedups are the best of 2 timed repetitions (the twin's default is
    # 6): printed, not gated; cut to keep the smoke near its time (PERF.md
    # §4).
    rows = scenario_sweep_torch.run(
        n_clients=20, rounds=30, speedup_rounds=150, smoke=True,
        out_dir=os.path.join(HERE, "results", "bench"), device=device,
        reps=2)
    drop = [r["scan_vs_eager"] for r in rows if r["link_dropout"]]
    pure = [r["scan_vs_eager"] for r in rows if not r["link_dropout"]]
    ratio = (sum(drop) / len(drop)) / (sum(pure) / len(pure))
    log(f"scenario_sweep_torch --smoke in {time.perf_counter() - t0:.1f} s: "
        + "; ".join(f"{r['scenario']} acc {r['final_acc']} latency "
                    f"{r['latency_s']} s energy {r['energy_j']} J scan vs "
                    f"eager {r['scan_vs_eager']}x" for r in rows)
        + f"; dropout/mobility speedup ratio {ratio:.2f}")
    if not all(math.isfinite(r["final_acc"]) and r["latency_s"] > 0
               for r in rows):
        raise AssertionError(f"scenario sweep: {rows}")
    out["sweep"] = {"rows": rows, "dropout_vs_mobility": ratio}
    return out


# ---------------------------------------------------------------------------
# Walk policies: the Metropolis chain and the importance-biased walks
# (staleness, label skew; mixing's γ = 0.5) on the main path's CNN.
WALK_BIAS = 0.5
# Rounds of the window whose dispatched operations are counted.
OPS_WINDOW = 3
# What a biased walk adds to each round: the fold y₀ + iw·(y₁ − y₀) (a
# subtract, a multiply, an add) and the round's iw picked from the
# window's column; the fleet also views iw as (K, 1).
FOLD_OPS = {"aten.add": 1, "aten.mul": 1, "aten.select": 1, "aten.sub": 1}
#: (label, fleet mode or None, trainer keywords, update kernel)
WALK_RUNS = (
    ("metropolis", None, dict(transition="metropolis"), "zone_update"),
    ("staleness", None, dict(walk_policy="staleness", walk_bias=WALK_BIAS),
     "zone_update"),
    ("label_skew", None, dict(walk_policy="label_skew", walk_bias=WALK_BIAS),
     "zone_update"),
    ("staleness batched_walk", None,
     dict(walk_policy="staleness", walk_bias=WALK_BIAS, batched_walk=True),
     "zone_update"),
    ("fleet3 staleness", "simultaneous",
     dict(walk_policy="staleness", walk_bias=WALK_BIAS), "multizone_update"))


def window_ops(trainer, rounds: int = OPS_WINDOW):
    """The ATen operations, by name, and the kernel wrappers' launches
    that the rounds of a new ``scan_fused`` window of ``rounds`` rounds
    dispatch (its warm-up round and its capture: what its CUDA graph
    replays), apart from the carry and input copies around them, and the
    number of rounds dispatched."""
    import collections

    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = collections.Counter()
    seen = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    rounds_of = trainer._window

    def counted(state, ins, *args, **kw):
        seen.append(int(ins["idx"].shape[0]))
        with Count():
            return rounds_of(state, ins, *args, **kw)

    sched = trainer.schedule(rounds, np.random.default_rng(3), start_round=1)
    state = trainer.init_state(0)
    torch.cuda.synchronize()
    zero_launch_counts()
    trainer._window = counted
    try:
        trainer.run_chunk(state, sched, "scan_fused")
    finally:
        del trainer._window
    torch.cuda.synchronize()
    ops.update({f"wrapper {k}": n for k, n in launch_counts().items() if n})
    return ops, sum(seen)


def ops_delta(got, want) -> dict:
    """``got − want`` per operation, where they differ."""
    return {k: got[k] - want[k] for k in sorted(set(got) | set(want))
            if got[k] != want[k]}


def phase_walks(device, model, data, hp, static: dict) -> dict:
    """Each of ``WALK_RUNS`` driven once through ``run_simulation``
    (``scan_fused``, 50 rounds in one captured window; launch counts
    exact per round), its host columns and importance weights held
    against eager and the CPU's ``schedule()``, eager against
    ``scan_fused`` in lockstep (:func:`compare_lockstep`), its captured
    windows bit for bit over two windows (the second a replay with new
    weights); steady times, busy share and kernels a round beside the
    ``static_regen`` paths of this call (``static``), and
    ``schedule()``'s host ms. The uniform Metropolis chain must carry no
    ``iw``, and a window of it must dispatch exactly the operations and
    launches of the static trainer's (:func:`window_ops`), a biased
    window exactly those and the fold's (``FOLD_OPS``) each round.
    ``batched_walk`` walks another stream than eager: its host columns
    are held to the CPU's ``schedule()`` and its captured ``scan`` to
    its rounds uncaptured."""
    import torch

    from repro_torch.fl.base import DeviceData
    from repro_torch.fl.fleet_trainer import FleetRWSADMMTrainer
    from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer

    seed = MAIN["seed"]
    cpu_data = DeviceData(*(t.cpu() for t in data))
    out = {}
    captures = {}
    for label, mode, kw, update in WALK_RUNS:
        def make(dev=device, dat=data, mode=mode, kw=kw):
            common = dict(batch_size=MAIN["batch"], zone_size=MAIN["zone"],
                          solver="closed_form", seed=seed, device=dev, **kw)
            if mode is None:
                return RWSADMMTrainer(model, dat, hp, **common)
            return FleetRWSADMMTrainer(
                model, dat, hp, n_walkers=FLEET["n_walkers"],
                sync_every=FLEET["sync_every"], fleet_mode=mode, **common)

        def make_cpu(make=make):
            return make("cpu", cpu_data)

        def make_static(mode=mode, dev="cpu", dat=cpu_data):
            if mode is None:
                return make_trainer(model, dat, hp, dev, seed)
            return make_fleet(model, dat, hp, dev, seed, mode)

        eager_walks = not kw.get("batched_walk", False)
        steps = FLEET["wall_steps"] if mode else MAIN["rounds"]
        unit = "wall step" if mode else "round"
        tag = f"walks, {label}"
        trainer = make()
        res, counts, peak, losses, acc = drive(trainer, steps, seed, update,
                                               tag)
        hit = (trainer.fleet_hitting_time() if mode
               else trainer.walker.hitting_time())
        sched = hold_host_columns(res, make, make_cpu, steps, tag, trainer,
                                  eager_walks)
        carries_iw = [k[-1] for k in trainer.windows]
        biased = trainer.walker.is_biased
        if (sched.iw is not None) != biased or any(
                c != biased for c in carries_iw):
            raise AssertionError(f"{tag}: iw column {sched.iw is not None}, "
                                 f"windows carrying iw {carries_iw}")
        lockstep = None
        if eager_walks:
            lock = compare_lockstep(make, FLEET["eager_steps"] if mode
                                    else MAIN["eager_rounds"],
                                    lambda st: {k: v for k, v in
                                                state_leaves(st).items()
                                                if k != "visited"},
                                    unit + "s", hp, tag)
            lockstep = lockstep_summary(lock)
        steady = time_steady_rounds(trainer, unit)
        ops, dispatched = window_ops(trainer)
        ref = make_static(dev=device, dat=data)
        surplus = ops_delta(ops, window_ops(ref)[0])
        del ref
        fold = dict(FOLD_OPS, **({"aten.view": 1} if mode else {}))
        want = {k: n * dispatched for k, n in fold.items()} if biased else {}
        base = static["fleet_path" if mode else "main_path"]
        sched_ms = {"walk": schedule_ms(make_cpu, steps),
                    "static_regen": schedule_ms(make_static, steps)}
        extra = (steady["kernel_launches_per_round"]
                 - base["kernel_launches_per_round"])
        log(f"{tag}: {steps} {unit}s scan_fused, wrapper counts "
            f"{counts['counts']}, launches run {counts['ran']} in "
            f"{counts['replays']} graph replay(s), loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, acc_personalized {acc:.4f}, hitting time "
            f"{hit}; steady scan_fused "
            f"{steady['scan_fused_round_ms']:.4f} ms/{unit} against "
            f"static_regen's {base['scan_fused_round_ms']:.4f} in this call "
            f"(scan {steady['scan_round_ms']:.4f} against "
            f"{base['scan_round_ms']:.4f}, eager "
            f"{steady['eager_round_ms']:.4f} against "
            f"{base['eager_round_ms']:.4f}), busy share "
            f"{steady['busy_share']:.3f} against {base['busy_share']:.3f}, "
            f"kernels a {unit} {steady['kernel_launches_per_round']:.1f} "
            f"against {base['kernel_launches_per_round']:.1f} "
            f"({extra:+.1f}); a {OPS_WINDOW}-{unit} window dispatches "
            f"{sum(ops.values())} operations and launches over "
            f"{dispatched} rounds, {surplus or 'none'} beside "
            f"static_regen's; host schedule() "
            f"of a {steps}-{unit} window "
            f"{sched_ms['walk']:.2f} ms against static_regen's "
            f"{sched_ms['static_regen']:.2f} ms; peak {peak / 2**30:.3f} GiB")
        if surplus != want:
            raise AssertionError(f"{tag}: its window dispatched {surplus} "
                                 f"beside static_regen's, not {want}")
        out[label] = {"launches": counts["counts"],
                      "launches_run": counts["ran"],
                      "graph_replays": counts["replays"],
                      "acc_personalized": acc,
                      "hitting_time": hit,
                      "iw_range": (None if sched.iw is None else
                                   [float(sched.iw.min()),
                                    float(sched.iw.max())]),
                      "schedule_ms": sched_ms,
                      "static_regen_round_ms": base["scan_fused_round_ms"],
                      "static_regen_kernels_per_round":
                          base["kernel_launches_per_round"],
                      "static_regen_busy_share": base["busy_share"],
                      "window_ops": sum(ops.values()),
                      "window_ops_beside_static": surplus,
                      "lockstep": lockstep,
                      **steady}
        captures[label] = (make, eager_walks)
        del trainer
        torch.cuda.empty_cache()
    out["capture"] = {}
    for label, (make, eager_walks) in captures.items():
        out["capture"].update(check_captures({f"walks, {label}": make},
                                             eager_walks))
    return out


def phase_single_client(device, model, data, hp) -> int:
    """One client's update through ``ops.fused_update`` at the CNN's
    width: the client's gradient at its x on one minibatch, then x, z and
    a token updated in one launch. Returns the launches counted."""
    import torch

    from repro_torch.kernels.rwsadmm_update import ops
    from repro_torch.kernels.rwsadmm_update.ref import fused_update_ref

    trainer = make_trainer(model, data, hp, device, MAIN["seed"])
    state = trainer.init_state(MAIN["seed"])
    client = torch.tensor([3], device=device)
    batch, keep = trainer.zone_batch_indices(client, trainer.round_key(11))
    _, grads = trainer.zone_loss_and_grad(state.clients.x[client], client,
                                          batch, keep)
    args = (state.clients.x[3], state.clients.z[3], state.server.y,
            grads[0], state.server.kappa)
    kw = dict(beta=hp.beta, eps_half=hp.eps_half,
              n_total=float(trainer.n_clients))
    torch.cuda.synchronize()
    zero_launch_counts()
    out = ops.fused_update(*args, **kw)
    torch.cuda.synchronize()
    launches = launch_counts()["fused_update"]
    want = fused_update_ref(*args, **kw)
    equal = all(torch.equal(a, b) for a, b in zip(out, want))
    log(f"single-client op: fused_update on client 3 (N = "
        f"{args[0].numel():,}): launches {launches}, equal to its plain "
        f"version {equal}, finite {all(bool(t.isfinite().all()) for t in out)}")
    if launches != 1 or not all(bool(t.isfinite().all()) for t in out):
        raise AssertionError("fused_update did not run once to a finite "
                             "result")
    return launches


# ---------------------------------------------------------------------------
# Captured windows against what they replace; a seed on the card and the
# host; the scaling twins.
CAPTURE = dict(window=5, windows=2)
PARITY = dict(n_samples=1200, n_clients=10, rounds=5, tol=1e-6)


def uncaptured_rounds(trainer, state, sched, use_fused: bool = True,
                      rounds=None, weighted: bool = True):
    """A window's rounds (or those of ``rounds``) in a loop outside any
    graph: ``_round_impl`` for the single walker, the fleet's round-robin
    or simultaneous step, each with the round's importance weight (fp32)
    under a biased policy unless ``weighted`` is False."""
    import numpy as np
    import torch

    dev = trainer.device
    idx = torch.as_tensor(sched.idx, dtype=torch.int64, device=dev)
    mask, keys = (torch.as_tensor(a, device=dev)
                  for a in (sched.mask, sched.keys))
    sync = getattr(sched, "sync", None)
    sync = None if sync is None else torch.as_tensor(sync, device=dev)
    iw = None if sched.iw is None or not weighted else torch.as_tensor(
        sched.iw.astype(np.float32), device=dev)
    for r in range(sched.rounds) if rounds is None else rounds:
        w = None if iw is None else iw[r]
        if sync is None:
            state, _ = trainer._round_impl(state, idx[r], mask[r], keys[r],
                                           w, use_fused=use_fused)
        elif sched.mode == "roundrobin":
            a = torch.tensor(int(sched.walker[r]), device=dev)
            state, _ = trainer._rr_step(state, idx[r], mask[r], a, sync[r],
                                        keys[r], w, use_fused=use_fused)
        else:
            state, _ = trainer._sim_step(state, idx[r], mask[r], sync[r],
                                         keys[r], w, use_fused=use_fused)
    return state


def state_leaves(state) -> dict:
    base = getattr(state, "base", state)
    out = {"x": base.clients.x, "z": base.clients.z, "y": base.server.y,
           "kappa": base.server.kappa, "visited": base.visited}
    if base is not state:
        out["tokens"] = state.tokens
    return {k: v.clone() for k, v in out.items()}


def phase_capture(device, model, data, hp) -> dict:
    """On the n = 100 CNN, cuDNN deterministic: two windows (the second a
    replay) of the captured ``scan`` against as many eager rounds, and of
    the captured ``scan_fused`` against the same rounds uncaptured, all
    from one seed; each pair must be equal bit for bit. Single walker,
    then the K = 3 fleet in both modes."""
    seed = MAIN["seed"]
    return check_captures({
        "single walker": lambda: make_trainer(model, data, hp, device, seed),
        "fleet simultaneous": lambda: make_fleet(model, data, hp, device,
                                                 seed),
        "fleet roundrobin": lambda: make_fleet(model, data, hp, device,
                                               seed, mode="roundrobin")})


def check_captures(configs: dict, eager_walks: bool = True) -> dict:
    """For each trainer factory of ``configs``: captured ``scan`` ≡ eager
    and captured ``scan_fused`` ≡ the same rounds uncaptured, bit for
    bit with cuDNN deterministic, over ``CAPTURE["windows"]`` windows;
    under a biased policy the second window (a replay) must carry other
    importance weights than the first. A ``batched_walk`` trainer's eager
    rounds walk another stream than its schedules (``eager_walks`` False):
    its captured ``scan`` is held to its rounds uncaptured instead."""
    import numpy as np
    import torch

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    seed, w = MAIN["seed"], CAPTURE["window"]
    out = {}
    try:
        for label, make in configs.items():
            runs, iws = {}, []
            for engine in ("eager", "scan", "uncaptured", "scan_fused"):
                tr = make()
                rng = np.random.default_rng(seed)
                state = tr.init_state(seed)
                for k in range(CAPTURE["windows"]):
                    if engine == "eager" and eager_walks:
                        for r in range(k * w, (k + 1) * w):
                            state, _ = tr.round(state, r, rng)
                        continue
                    sched = tr.schedule(w, rng, start_round=k * w)
                    if engine == "scan_fused" and sched.iw is not None:
                        iws.append(sched.iw)
                    if engine == "eager":      # the scan rounds uncaptured
                        state = uncaptured_rounds(tr, state, sched, False)
                    elif engine == "uncaptured":
                        state = uncaptured_rounds(tr, state, sched)
                    else:
                        state, _ = tr.run_chunk(state, sched, engine)
                torch.cuda.synchronize()
                runs[engine] = state_leaves(state)
                if engine in ("scan", "scan_fused"):
                    runs[engine + " replays"] = sum(
                        v.replays for v in tr.windows.values())
                del tr, state
                torch.cuda.empty_cache()

            def diff(a, b):
                return {k: float((runs[a][k].double()
                                  - runs[b][k].double()).abs().max())
                        for k in runs[a]}
            row = {"scan_vs_eager": diff("scan", "eager"),
                   "scan_fused_vs_uncaptured": diff("scan_fused",
                                                    "uncaptured"),
                   "replays": runs["scan replays"]}
            row["scan_equal"] = all(torch.equal(runs["scan"][k],
                                                runs["eager"][k])
                                    for k in runs["eager"])
            row["fused_equal"] = all(torch.equal(runs["scan_fused"][k],
                                                 runs["uncaptured"][k])
                                     for k in runs["uncaptured"])
            if iws:
                row["iw_windows_differ"] = not np.array_equal(*iws)
                row["iw_range"] = [float(min(a.min() for a in iws)),
                                   float(max(a.max() for a in iws))]
            against = "eager" if eager_walks else "the scan rounds uncaptured"
            log(f"captured windows, {label}: {CAPTURE['windows']} windows "
                f"of {w} rounds ({row['replays']} replays): captured scan "
                f"vs {against} bitwise {row['scan_equal']} (max_abs_diff "
                f"{row['scan_vs_eager']}); captured scan_fused vs the same "
                f"rounds uncaptured bitwise {row['fused_equal']} "
                f"(max_abs_diff {row['scan_fused_vs_uncaptured']})"
                + (f"; importance weights {row['iw_range']}, the replayed "
                   f"window's differ from the first's "
                   f"{row['iw_windows_differ']}" if iws else ""))
            if not (row["scan_equal"] and row["fused_equal"]
                    and row.get("iw_windows_differ", True)):
                raise AssertionError(f"captured windows, {label}: {row}")
            out[label] = row
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    return out


def phase_device_parity(device, model, data, hp) -> dict:
    """One seed on the card and on this machine's CPU, TF32 off (Queue 3
    fault 1: the draws depended on the device). Held: every round's batch
    indices and keep masks equal bit for bit on both devices (MLR, MLP
    on both solvers, the CNN), and x, z, y after one eager round at the
    round tier's ``PARITY["tol"]`` (MLR, MLP on ``closed_form``).
    Printed, not held: the gap after ``PARITY["rounds"]`` rounds, where
    the devices' different matmul summation orders have compounded."""
    import numpy as np
    import torch

    from repro_torch.core.rwsadmm import RWSADMMHparams
    from repro_torch.data import build_federated, make_image_dataset, \
        pathological_split
    from repro_torch.fl.base import to_device_data
    from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer
    from repro_torch.models.small import get_model

    imgs, labels = make_image_dataset(PARITY["n_samples"], seed=0)
    fed = build_federated(imgs, labels, pathological_split(
        labels, PARITY["n_clients"], seed=0))
    small = {"cpu": to_device_data(fed, "cpu"),
             "cuda": to_device_data(fed, device)}
    cnn = {"cpu": type(data)(*(t.cpu() for t in data)), "cuda": data}

    def run(mdl, dat, dev, kw):
        """Each round's draws and the state after rounds 1 and R."""
        tr = RWSADMMTrainer(mdl, dat, kw.get("hp", RWSADMMHparams()),
                            batch_size=MAIN["batch"], zone_size=MAIN["zone"],
                            solver=kw["solver"], seed=0, device=dev)
        sched = tr.schedule(PARITY["rounds"], np.random.default_rng(0))
        steps = None if kw["solver"] == "closed_form" else tr.inner_steps
        draws = []
        for r in range(sched.rounds):
            idx, keep = tr.zone_batch_indices(
                torch.as_tensor(sched.idx[r], dtype=torch.int64, device=dev),
                torch.as_tensor(sched.keys[r], device=dev), steps)
            draws += [idx.cpu()] + [k.cpu() for k in keep or ()]
        tr = RWSADMMTrainer(mdl, dat, kw.get("hp", RWSADMMHparams()),
                            batch_size=MAIN["batch"], zone_size=MAIN["zone"],
                            solver=kw["solver"], seed=0, device=dev)
        rng, state, after = np.random.default_rng(0), tr.init_state(0), []
        for r in range(PARITY["rounds"]):
            state, _ = tr.round(state, r, rng)
            if r in (0, PARITY["rounds"] - 1):
                after.append([t.cpu().clone() for t in (
                    state.clients.x, state.clients.z, state.server.y)])
        return draws, after

    out = {}
    cases = [(f"{m}/{solver}", get_model(m, (28, 28, 1)), small,
              {"solver": solver}) for m in ("mlr", "mlp")
             for solver in ("closed_form", "prox_sgd")]
    cases.append(("cnn/closed_form", model, cnn,
                  {"solver": "closed_form", "hp": hp}))
    for label, mdl, datas, kw in cases:
        (d_cpu, s_cpu), (d_card, s_card) = (run(mdl, datas[d], dev, kw)
                                            for d, dev in (("cpu", "cpu"),
                                                           ("cuda", device)))
        gaps = [max(float((a - b).abs().max()) for a, b in zip(u, v))
                for u, v in zip(s_cpu, s_card)]
        row = {"draws_equal": all(torch.equal(a, b)
                                  for a, b in zip(d_cpu, d_card)),
               "after_1": gaps[0], f"after_{PARITY['rounds']}": gaps[1],
               "held": label in ("mlr/closed_form", "mlp/closed_form")}
        row["ok"] = row["draws_equal"] and (not row["held"] or all(
            torch.allclose(a, b, atol=PARITY["tol"], rtol=PARITY["tol"])
            for a, b in zip(s_cpu[0], s_card[0])))
        out[label] = row
        log(f"device parity {label}: {PARITY['rounds']} rounds' draws "
            f"bitwise equal card vs CPU {row['draws_equal']}; x, z, y "
            f"max_abs_diff after 1 eager round {gaps[0]:.3g}"
            + (f" (held at {PARITY['tol']}: {row['ok']})" if row["held"]
               else " (not held)")
            + f", after {PARITY['rounds']} {gaps[1]:.3g} (not held)")
        if not row["ok"]:
            raise AssertionError(f"device parity {label}: {row}")
    return out


def phase_twins(device) -> dict:
    """Both scaling twins at their smoke sizes (rows to a git-ignored
    file)."""
    from benchmarks import fleet_scaling_torch, scan_scaling_torch

    out_file = os.path.join(HERE, "results", "bench",
                            "BENCH_torch_scaling.json")
    t0 = time.perf_counter()
    scan = scan_scaling_torch.run(30, (20,), device, out_file)
    fleet = fleet_scaling_torch.run(30, (40,), (1, 3, 5),
                                    ("roundrobin", "simultaneous"), device,
                                    out_file)
    hits = fleet_scaling_torch.hitting_times(40, (1, 3, 5), 600, device)
    log(f"scaling twins at smoke sizes in {time.perf_counter() - t0:.1f} s: "
        f"scan_scaling rounds/s {scan}; fleet_scaling rounds/s "
        f"{ {f'{m}/K{k}': v for (m, _, k), v in fleet.items()} }; fleet "
        f"hitting time {hits}")
    return {"scan_scaling": scan,
            "fleet_scaling": {f"{m}/n{n}/K{k}": v
                              for (m, n, k), v in fleet.items()},
            "hitting_time": hits}


# ---------------------------------------------------------------------------
# The paper's result scripts on the card, at the reference's sizes, and
# the full-length quickstart. Rounds cut to keep the smoke near its time
# (PERF.md §4): convergence 100 → 15, Fig. 3/4 80 → 20, the comparison
# 200 → 30, Table 2's rounds a client 8 → 1. The quickstart keeps its 300
# rounds (its hitting time and MB a round are held to the reference's).
PAPER = dict(convergence_rounds=8, hyperparam_rounds=10,
             ablation_rounds=40, comparison_rounds=15,
             table2_clients=(20, 50, 100), table2_rounds_per_client=1,
             quickstart_rounds=300)
# The reference's quickstart on the CPU (ROADMAP Queue 1 item 9): its
# hitting time and MB a round (the port's CPU run gives the same), and
# its accuracies, printed beside the card's.
QUICKSTART_REF = dict(hitting_time=58, rwsadmm_mb=2.92, fedavg_mb=7.17,
                      rwsadmm_acc=0.9700, fedavg_acc=0.9509)


def phase_paper(device) -> dict:
    """The six paper-script twins on the card, then the quickstart at its
    full 300 rounds. Gated: the walk-policy sweep's hitting times and
    staleness equal a CPU run of the same twin; Table 2's ``comm_mb``
    equals the CPU ``schedule()`` of the same trainers; the ablations'
    literal Eq. 11 moves 0.0; the quickstart's hitting time and MB a
    round equal the reference's. Accuracies are printed."""
    import importlib.util

    import numpy as np
    import torch

    from benchmarks import ablations_torch, convergence_torch, \
        hyperparam_torch, mixing_torch, table1_torch, table2_scaling_torch
    from repro_torch.models.small import get_model

    out_dir = os.path.join(HERE, "results", "bench")
    rows_file = os.path.join(out_dir, "BENCH_torch_scaling.json")
    out, times = {}, {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        times[name] = time.perf_counter() - t0
        return res

    curves = timed("convergence", convergence_torch.run,
                   PAPER["convergence_rounds"], out_dir, device)
    out["convergence"] = {f"{m}/{a}": float(acc[-1])
                          for (m, a), (_, acc) in curves.items()}
    t2 = timed("table2_scaling", table2_scaling_torch.run, out_dir, device,
               PAPER["table2_clients"], PAPER["table2_rounds_per_client"])
    planned = []
    for row in t2:
        n = row["n_clients"]
        data, shape = table1_torch.mnist_like_fed(n_clients=n,
                                                  n_samples=200 * n,
                                                  device="cpu")
        tr = table1_torch.make_trainer("rwsadmm", get_model("mlp", shape),
                                       data, zone=8, device="cpu")
        sched = tr.schedule(row["rounds"], np.random.default_rng(0))
        zeros = torch.zeros(row["rounds"])
        total = sum(m["comm_bytes"] for m in tr.chunk_round_metrics(
            sched, {"train_loss": zeros, "kappa": zeros}, 0))
        planned.append(round(total / 1e6, 1))
    out["table2"] = t2
    hyper = timed("hyperparam", hyperparam_torch.run,
                  PAPER["hyperparam_rounds"], out_dir, device)
    out["hyperparam"] = hyper
    report = timed("mixing report", mixing_torch.mixing_report)
    sweep = timed("mixing sweep", mixing_torch.policy_sweep, device=device,
                  out=rows_file)
    cpu_sweep = timed("mixing sweep on the CPU", mixing_torch.policy_sweep,
                      device="cpu", out=os.path.join(out_dir,
                                                     "mixing_cpu.json"))
    host = ("hitting_time", "staleness_max", "staleness_p50")
    out["mixing"] = {"report": report, "sweep": sweep}
    abl = timed("ablations", ablations_torch.run, PAPER["ablation_rounds"],
                device)
    out["ablations"] = abl

    def load(path):
        spec = importlib.util.spec_from_file_location(Path(path).stem, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    comparison = load(os.path.join(HERE, "examples",
                                   "personalization_comparison_torch.py"))
    out["personalization_comparison"] = timed(
        "personalization_comparison", comparison.main,
        PAPER["comparison_rounds"], device)
    quick = load(os.path.join(HERE, "examples", "quickstart_torch.py"))
    rounds = PAPER["quickstart_rounds"]
    res, fed_res, trainer = timed("quickstart", quick.main, rounds, device)
    q = {"hitting_time": trainer.walker.hitting_time(),
         "rwsadmm_mb": round(res.total_comm_bytes / rounds / 1e6, 2),
         "fedavg_mb": round(fed_res.total_comm_bytes / rounds / 1e6, 2),
         "rwsadmm_acc": res.final["acc_personalized"],
         "fedavg_acc": fed_res.final["acc_global"]}
    out["quickstart"] = q
    out["seconds"] = times

    checks = {
        "sweep host columns equal the CPU run's":
            [{k: r[k] for k in host} for r in sweep]
            == [{k: r[k] for k in host} for r in cpu_sweep],
        "table2 comm_mb equals the CPU schedule's":
            [r["comm_mb"] for r in t2] == planned,
        "literal Eq. 11 moves 0.0": abl["literal_eq11_first_step"] == 0.0,
        "quickstart hitting time and MB a round equal the reference's":
            all(q[k] == QUICKSTART_REF[k]
                for k in ("hitting_time", "rwsadmm_mb", "fedavg_mb")),
    }
    log("paper scripts on the card (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in times.items()))
    log(f"paper scripts: Fig. 2 final accuracies {out['convergence']}; "
        f"Table 2 {t2} (comm_mb from the CPU schedule {planned}); Fig. 3/4 "
        f"{hyper}; mixing report {[(r['graph'], r['tau'], r['holds']) for r in report]}; "
        f"policy sweep "
        f"{[(r['name'], r['hitting_time'], r['staleness_max'], r['acc']) for r in sweep]}"
        f" (CPU {[(r['hitting_time'], r['staleness_max']) for r in cpu_sweep]}); "
        f"ablations {abl}")
    log(f"quickstart, {rounds} rounds on the card: RWSADMM "
        f"acc_personalized {q['rwsadmm_acc']:.4f} (reference on the CPU "
        f"{QUICKSTART_REF['rwsadmm_acc']}), FedAvg acc_global "
        f"{q['fedavg_acc']:.4f} (reference {QUICKSTART_REF['fedavg_acc']}); "
        f"MB a round {q['rwsadmm_mb']} and {q['fedavg_mb']} (reference "
        f"{QUICKSTART_REF['rwsadmm_mb']}, {QUICKSTART_REF['fedavg_mb']}), "
        f"hitting time {q['hitting_time']} (reference "
        f"{QUICKSTART_REF['hitting_time']})")
    log(f"paper scripts gates: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"paper scripts: {checks}")
    out["checks"] = checks
    return out


# ---------------------------------------------------------------------------
# The paper's baselines (FedAvg, Per-FedAvg, pFedMe, Ditto, APFL, Walkman).
BASELINES = ("fedavg", "perfedavg", "pfedme", "ditto", "apfl", "walkman")
# tests/test_fl_trainers.py:22-76 at its settings: 1,200 MNIST-shaped
# samples over 10 clients, MLR, 5 clients a round for 60 rounds; Walkman
# (one client a round) 900 rounds, held on its global model.
GATES = dict(n_samples=1200, n_clients=10, clients_per_round=5, rounds=60,
             walkman_rounds=900, acc={"fedavg": 0.6, "perfedavg": 0.5,
                                      "pfedme": 0.6, "ditto": 0.6,
                                      "apfl": 0.6, "walkman": 0.35})
# benchmarks/table1.py's grid through its port twin; 120 rounds as there
# for the kernel's shapes and the plain hold, the grid itself cut to 10
# (it took 144 s of the smoke at 120, ~67 s at 40; the 120-round grid's
# reading is the twin's own run, PERF.md §6).
TABLE1_ROUNDS = 120
TABLE1_GRID_ROUNDS = 10
#: clients of each Table 1 dataset (``benchmarks/table1_torch.datasets``)
TABLE1_CLIENTS = {"mnist_like": 10, "synthetic": 20}
TABLE1_PERSONALIZED = ("perfedavg", "pfedme", "ditto", "apfl", "rwsadmm")
# The reference's RWSADMM cells at seed 0 on the CPU (benchmarks/table1.py,
# 120 rounds; ROADMAP Queue 3), beside which the port's card run prints
# its own at the grid's depth: the two packages draw the same batches.
TABLE1_REFERENCE = {"mnist_like/mlr": 98.45, "mnist_like/mlp": 96.57,
                    "synthetic/mlr": 79.12, "synthetic/mlp": 75.52}
# Every baseline on the single walker's CNN configuration (n = 100,
# batch 20), 10 clients a round; Walkman 4× the rounds, as table1.py.
# FedAvg, Ditto and APFL step at the reference's lr 0.05. Over seeds 0-8
# at 20 rounds (tests/test_torch_cnn_baselines_probe.py) the port stays
# finite at lr 0.05 on every seed, also from its initial state scaled by
# 1 ± 1e-7, and so does the reference on every seed it ran, this
# configuration's seed 0 with its ±1e-7 runs among them; Per-FedAvg (at
# its defaults) goes non-finite on seed 4 in both packages, the
# reference in round 1. Where the fp32 runs part, they part as each
# package parts from itself one ulp away; the round itself equals the
# reference's in float64 (tests/test_torch_run_float64*.py).
CNN_BASELINES = dict(rounds=10, walkman_rounds=40, clients_per_round=10,
                     lr=0.05, steady_rounds=10, profiled_rounds=3)
TAKES_LR = ("fedavg", "ditto", "apfl")


def replay_host_draws(name: str, n: int, m: int, rounds: int, seed: int,
                      param_bytes: int) -> dict:
    """What a run's host RNG draws must give, replayed with numpy and the
    port's host-side graph and walk alone: each round's cohort (or
    Walkman's visited client) and ``comm_bytes``."""
    import numpy as np

    from repro_torch.core.graph import DynamicGraph
    from repro_torch.core.markov import RandomWalkServer

    rng = np.random.default_rng(seed)
    out = {"cohorts": [], "clients": [], "comm_bytes": []}
    if name == "walkman":
        graph = DynamicGraph(n, 5, 10, seed=seed)
        walker = RandomWalkServer(seed=seed + 1)
        walker.reset(graph.current())
    for r in range(rounds):
        if name == "walkman":
            g = graph.step() if r > 0 else graph.current()
            out["clients"].append(walker.step(g) if r > 0
                                  else walker.position)
            out["comm_bytes"].append(2 * param_bytes)
        else:
            out["cohorts"].append(
                rng.choice(n, size=m, replace=False).tolist())
            out["comm_bytes"].append(2 * m * param_bytes)
        rng.integers(2**31 - 1)                      # the round's seed
    return out


def record_cohorts(trainer) -> list:
    """Wrap ``select_clients`` to keep every cohort it returns."""
    cohorts, select = [], trainer.select_clients

    def record(*args):
        cohorts.append(select(*args).tolist())
        return cohorts[-1]
    trainer.select_clients = record
    return cohorts


def make_baseline(name: str, model, data, device, **kw):
    from repro_torch.baselines import REGISTRY

    if name == "walkman":
        return REGISTRY[name](model, data, beta=3.0, device=device)
    return REGISTRY[name](model, data, device=device, **kw)


def final_losses_finite(res) -> bool:
    losses = [v for k, v in res.final.items() if k.startswith("loss")]
    losses += [m["train_loss"] for m in res.round_metrics
               if "train_loss" in m]
    return bool(losses) and all(math.isfinite(v) for v in losses)


def want_threefry(name: str, rounds: int, evals: int, n_clients: int
                  ) -> dict:
    """Threefry launches of a baseline's ``run_simulation``: its rounds'
    (``BASELINE_THREEFRY``) and, for Per-FedAvg and pFedMe, one draws
    launch per evaluated chunk of clients."""
    from repro_torch.fl.base import EVAL_CHUNK

    draws, bits = BASELINE_THREEFRY[name]
    chunks = math.ceil(n_clients / EVAL_CHUNK) if name in EVAL_DRAWS else 0
    return {"threefry_bits": bits * rounds,
            "threefry_draws": draws * rounds + evals * chunks}


def baseline_gates(device) -> dict:
    """The reference's own accuracy gates on the card, each run's host
    draws held against a numpy replay, no update kernel launched and the
    draws through threefry, each entry launched as often as the
    baseline's key tree asks."""
    import torch

    from repro_torch.data import build_federated, make_image_dataset, \
        pathological_split
    from repro_torch.fl.base import to_device_data
    from repro_torch.fl.simulation import run_simulation
    from repro_torch.models.small import get_model

    imgs, labels = make_image_dataset(GATES["n_samples"], seed=0)
    parts = pathological_split(labels, GATES["n_clients"], seed=0)
    data = to_device_data(build_federated(imgs, labels, parts), device)
    model = get_model("mlr", (28, 28, 1))
    param_bytes = 4 * sum(p.numel() for p in model.parameters())
    out = {}
    for name in BASELINES:
        rounds = GATES["walkman_rounds" if name == "walkman" else "rounds"]
        m = GATES["clients_per_round"]
        trainer = make_baseline(name, model, data, device,
                                clients_per_round=m)
        cohorts = record_cohorts(trainer)
        torch.cuda.synchronize()
        zero_launch_counts()
        res = run_simulation(trainer, rounds=rounds, eval_every=rounds,
                             seed=0)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = replay_host_draws(name, GATES["n_clients"], m, rounds, 0,
                                 param_bytes)
        got = {"cohorts": cohorts,
               "clients": [r["client"] for r in res.round_metrics
                           if "client" in r],
               "comm_bytes": [r["comm_bytes"] for r in res.round_metrics]}
        which = "acc_global" if name == "walkman" else "acc"
        acc = res.final[which]
        row = {"acc": acc, "threshold": GATES["acc"][name],
               "rounds": rounds, "wall_s": res.wall_time_s,
               "replay_equal": got == want,
               "finite": final_losses_finite(res),
               "update_launches": sum(counts[k] for k in UPDATES),
               "threefry": {k: counts[k] for k in THREEFRY},
               "threefry_want": want_threefry(name, rounds, 1,
                                              GATES["n_clients"])}
        log(f"baseline gate {name}: {rounds} rounds in "
            f"{res.wall_time_s:.2f} s, {which} "
            f"{acc:.4f} (gate > {row['threshold']}), host draws equal to "
            f"the numpy replay {row['replay_equal']} ({len(cohorts)} "
            f"cohorts, {len(got['clients'])} visited clients), port kernel "
            f"launches {counts}")
        if not (acc > row["threshold"] and row["replay_equal"]
                and row["finite"] and row["update_launches"] == 0
                and row["threefry"] == row["threefry_want"]):
            raise AssertionError(f"baseline gate {name} failed: {row}")
        out[name] = row
    return out


def table1_grid(device) -> dict:
    """``benchmarks/table1_torch.run`` one algorithm at a time, with the
    launch counts zeroed before and read after each."""
    import torch

    from benchmarks import table1_torch

    rows, launches = [], {}
    out_dir = os.path.join(HERE, "results", "bench")   # git-ignored
    for algo in table1_torch.ALGOS + ["rwsadmm_cf"]:
        torch.cuda.synchronize()
        zero_launch_counts()
        got = table1_torch.run(TABLE1_GRID_ROUNDS, out_dir, device, [algo])
        torch.cuda.synchronize()
        counts = launch_counts()
        launches[algo] = counts
        # Only rwsadmm_cf's windows launch (and capture) the zone kernel;
        # every row draws its batches through threefry (no keep masks:
        # MLR and MLP have no dropout): a baseline as its key tree asks, a
        # window's round (warm-up and capture) one draws launch, prox-SGD's
        # after one split of the zone's keys.
        zone = (algo == "rwsadmm_cf") == (counts["zone_update"] > 0)
        tf_counts = {k: counts[k] for k in THREEFRY}
        if algo in BASELINE_THREEFRY:
            want = [want_threefry(algo, r["rounds"], 1,
                                  TABLE1_CLIENTS[r["dataset"]]) for r in got]
            want = {k: sum(w[k] for w in want) for k in THREEFRY}
        else:
            draws = sum(r["rounds"] + 1 for r in got)
            want = {"threefry_draws": draws,
                    "threefry_bits": draws if algo == "rwsadmm" else 0}
        if not (zone and all(counts[k] == 0 for k in UPDATES[1:])
                and tf_counts == want
                and all(math.isfinite(r["loss"]) for r in got)):
            raise AssertionError(f"table1 {algo}: launches {counts} (want "
                                 f"{want}), rows {got}")
        rows += got
    for r in rows:
        log(f"table1 {r['dataset']}/{r['model']}/{r['algo']}: acc "
            f"{r['acc']:.2f} % acc_global {r['acc_global']:.2f} %, "
            f"{r['time_s'] / r['rounds'] * 1e3:.2f} ms per round over "
            f"{r['rounds']} rounds (one eval included), comm "
            f"{r['comm_mb']:.2f} MB")
    reading = {}
    for ds in ("mnist_like", "synthetic"):
        for model in ("mlr", "mlp"):
            acc = {r["algo"]: r["acc"] for r in rows
                   if (r["dataset"], r["model"]) == (ds, model)}
            pers = sorted((acc[a] for a in TABLE1_PERSONALIZED),
                          reverse=True)
            reading[f"{ds}/{model}"] = {
                "rwsadmm": acc["rwsadmm"],
                "reference_rwsadmm": TABLE1_REFERENCE[f"{ds}/{model}"],
                "rwsadmm_rank": pers.index(acc["rwsadmm"]) + 1,
                "of": len(pers),
                "rwsadmm_minus_fedavg": acc["rwsadmm"] - acc["fedavg"]}
    log(f"table1 reading at {TABLE1_GRID_ROUNDS} rounds (not gated): "
        f"RWSADMM's accuracy beside the reference's seed-0 CPU cell at "
        f"{TABLE1_ROUNDS} rounds, its rank among "
        f"the personalized rows and its gap over FedAvg in points: "
        f"{reading}")
    return {"rows": rows, "reading": reading, "launches": launches,
            "cf_vs_plain": hold_cf_against_plain(device)}


def hold_cf_against_plain(device) -> dict:
    """The grid's mnist_like MLR ``rwsadmm_cf`` row run from seed 0 on one
    schedule three times: on ``scan_fused`` through the zone kernel (one
    captured window), with the kernel's plain version in its place (the
    same rounds uncaptured: the plain version copies n from the host,
    which a capture refuses), and on ``scan`` (the unfused fold). The
    first two must agree at ``KERNEL_TOL`` (the same arithmetic each
    round); ``scan`` folds y in another order, so it is printed beside
    them, not held."""
    import types

    import numpy as np
    import torch

    from benchmarks import table1_torch
    from repro_torch.fl import rwsadmm_trainer
    from repro_torch.kernels.rwsadmm_update import ref
    from repro_torch.models.small import get_model

    data, shape = table1_torch.datasets(device)["mnist_like"]
    model = get_model("mlr", shape)
    runs = {"kernel": ("scan_fused", rwsadmm_trainer.fused_ops),
            "plain": ("scan_fused", types.SimpleNamespace(
                zone_fused_update=ref.zone_fused_update_ref)),
            "scan": ("scan", rwsadmm_trainer.fused_ops)}
    final, acc = {}, {}
    kernel_ops = rwsadmm_trainer.fused_ops
    try:
        for label, (engine, ops) in runs.items():
            rwsadmm_trainer.fused_ops = ops
            tr = table1_torch.make_trainer("rwsadmm_cf", model, data,
                                           device=device)
            sched = tr.schedule(TABLE1_ROUNDS, np.random.default_rng(0))
            if label == "plain":
                state = uncaptured_rounds(tr, tr.init_state(0), sched)
            else:
                state, _ = tr.run_chunk(tr.init_state(0), sched,
                                        engine=engine)
            final[label] = (state.clients.x, state.clients.z, state.server.y)
            acc[label] = tr.evaluate(state)["acc"]
    finally:
        rwsadmm_trainer.fused_ops = kernel_ops
    torch.cuda.synchronize()

    def err(label):
        return {k: float((a - b).abs().max()) for k, a, b in
                zip("xzy", final["kernel"], final[label])}
    row = {"cell": "mnist_like/mlr", "rounds": TABLE1_ROUNDS,
           "err": err("plain"), "acc": acc,
           "bitwise": all(torch.equal(a, b) for a, b in
                          zip(final["kernel"], final["plain"])),
           "scan_err": err("scan")}
    log(f"table1 {row['cell']}/rwsadmm_cf, {TABLE1_ROUNDS} rounds from one "
        f"schedule: zone kernel vs its plain version max_abs_err "
        f"{row['err']} (bitwise {row['bitwise']}); vs scan's unfused fold "
        f"{row['scan_err']} (not held); acc {acc}")
    if not all(torch.allclose(a, b, atol=KERNEL_TOL, rtol=KERNEL_TOL)
               for a, b in zip(final["kernel"], final["plain"])):
        raise AssertionError(f"rwsadmm_cf on the zone kernel disagrees "
                             f"with its plain version: {row}")
    return row


def baselines_on_cnn(device, model, data) -> dict:
    """Every baseline on the full-width CNN configuration: a run of
    ``run_simulation``, steady ms per round, peak memory, busy share from
    a profile, and one profiled FedAvg round's top device operations."""
    import numpy as np
    import torch

    from repro_torch.fl.simulation import run_simulation

    cfg = CNN_BASELINES
    out = {}
    for name in BASELINES:
        rounds = cfg["walkman_rounds" if name == "walkman" else "rounds"]

        kw = {"clients_per_round": cfg["clients_per_round"]}
        if name in TAKES_LR:
            kw["lr"] = cfg["lr"]

        def make():
            return make_baseline(name, model, data, device, **kw)
        run_simulation(make(), rounds=2, eval_every=2, seed=1)   # warm-up
        trainer = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        res = run_simulation(trainer, rounds=rounds, eval_every=rounds,
                             seed=0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts = launch_counts()

        rng = np.random.default_rng(1)
        box = {"state": trainer.init_state(1), "r": 0}

        def one_round():
            box["state"], _ = trainer.round(box["state"], box["r"], rng)
            box["r"] += 1
        one_round()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cfg["steady_rounds"]):
            one_round()
        torch.cuda.synchronize()
        steady = (time.perf_counter() - t0) / cfg["steady_rounds"] * 1e3
        prof = profile_breakdown(one_round, cfg["profiled_rounds"],
                                 f"{name} cnn round")
        row = {"rounds": rounds, "rounds_per_s": rounds / res.wall_time_s,
               "steady_ms": steady, "peak_gib": peak / 2**30,
               "busy_share": prof["busy_share"],
               "device_ms": prof["busy_ms"], "launches": prof["launches"],
               "acc": res.final["acc"],
               "acc_global": res.final.get("acc_global"),
               "finite": final_losses_finite(res)}
        log(f"baseline cnn {name}: {rounds} rounds in {res.wall_time_s:.3f} "
            f"s = {row['rounds_per_s']:.2f} rounds/s (one eval included), "
            f"steady {steady:.2f} ms per round, device busy "
            f"{prof['busy_ms']:.2f} ms per round (share "
            f"{prof['busy_share']:.3f} of the profiled round), "
            f"{prof['launches']:.0f} launches per round, peak allocated "
            f"{row['peak_gib']:.3f} GiB, acc {row['acc']:.4f}, port kernel "
            f"launches {counts}")
        if not row["finite"] or any(counts[k] for k in UPDATES):
            raise AssertionError(f"baseline cnn {name}: {row}, {counts}")
        out[name] = row
        del trainer, box
        torch.cuda.empty_cache()
    return out


def phase_baselines(device, model, data) -> dict:
    """The baselines on the card: the reference's accuracy gates, the
    Table 1 grid, and every baseline on the full-width CNN."""
    return {"gates": baseline_gates(device), "table1": table1_grid(device),
            "cnn": baselines_on_cnn(device, model, data)}


def time_steady_rounds(trainer, unit: str) -> dict:
    """Steady ms per round (per wall step for the simultaneous fleet) of
    each engine on a warm trainer (no schedule, no eval inside the timed
    region; eager plans its rounds inside; each scan engine's window is
    captured before the timed runs, which replay it), the evaluation's
    own time, and a profile of a replayed scan_fused window: the kernels
    it runs, the host's CUDA calls, device busy share, top kernels."""
    import collections

    import numpy as np
    import torch

    times: dict[str, list[float]] = {e: [] for e in ENGINES}
    n, rounds = 30, 10
    for engine in ENGINES[1:]:    # capture the timed and profiled windows
        for length in (n, rounds):
            trainer.run_chunk(trainer.init_state(0), trainer.schedule(
                length, np.random.default_rng(9), start_round=1), engine)
    for rep in range(3):          # engines in turn, so drift hits all alike
        for engine in ENGINES:
            rng = np.random.default_rng(rep)
            state = trainer.init_state(0)
            if engine == "eager":
                state, _ = trainer.round(state, 0, rng)   # plan + warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for r in range(1, n + 1):
                    state, _ = trainer.round(state, r, rng)
            else:
                sched = trainer.schedule(n, rng, start_round=1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = trainer.run_chunk(state, sched, engine=engine)
            torch.cuda.synchronize()
            times[engine].append((time.perf_counter() - t0) / n * 1e3)
    out = {}
    for engine, ts in times.items():
        out[f"{engine}_round_ms"] = sorted(ts)[1]        # median of 3
        out[f"{engine}_round_ms_runs"] = ts
    t0 = time.perf_counter()
    trainer.evaluate(state)
    out["eval_s"] = time.perf_counter() - t0

    sched = trainer.schedule(rounds, np.random.default_rng(2), start_round=1)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        trainer.run_chunk(state, sched, engine="scan_fused")
        end.record()
        torch.cuda.synchronize()
    # Kernel rows only (op rows would count the same device time twice).
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    kernels = {e.key: e.self_device_time_total / rounds / 1e3 for e in rows}
    out["kernel_ms_per_round"] = sum(kernels.values())
    out["kernel_launches_per_round"] = sum(e.count for e in rows) / rounds
    # Busy time is the union of the kernels' intervals: kernels on cuDNN's
    # own streams may overlap, so their summed time can exceed the
    # window. Its share is taken against the unprofiled steady round time
    # above and against the profiled window's own elapsed time.
    spans = [e for e in prof.events() if e.device_type == cuda]
    busy_ms = union_ms([(e.time_range.start, e.time_range.end)
                        for e in spans]) / 1e3 / rounds
    out["kernel_streams"] = len({e.device_resource_id for e in spans})
    # The host's side of the window: graph launches, kernel launches and
    # copies it issued (the replay is one cudaGraphLaunch).
    calls = collections.Counter(
        e.name for e in prof.events()
        if e.device_type != cuda and e.name.startswith("cuda")
        and any(w in e.name for w in ("GraphLaunch", "LaunchKernel",
                                      "Memcpy")))
    out["host_calls_per_window"] = dict(calls)
    out["kernels_per_window"] = out["kernel_launches_per_round"] * rounds
    out["device_ms_per_round"] = busy_ms
    out["busy_share"] = busy_ms / out["scan_fused_round_ms"]
    out["profiled_round_ms"] = start.elapsed_time(end) / rounds
    out["busy_share_profiled"] = busy_ms / out["profiled_round_ms"]
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log(f"steady ms/{unit} (median of 3 runs of {n}; runs): " + ", ".join(
        f"{e} {out[e + '_round_ms']:.3f} "
        f"({' '.join(f'{t:.3f}' for t in out[e + '_round_ms_runs'])})"
        for e in ENGINES)
        + f"; evaluate over {trainer.n_clients} clients {out['eval_s']:.3f} s")
    log(f"profile: a replayed {rounds}-{unit} scan_fused window (one CUDA "
        f"graph) runs {out['kernels_per_window']:.0f} kernels, "
        f"{out['kernel_launches_per_round']:.1f} per {unit}; the host issued "
        f"{out['host_calls_per_window']} for it; its kernels take "
        f"{out['kernel_ms_per_round']:.3f} "
        f"device ms per {unit} in {out['kernel_launches_per_round']:.1f} "
        f"launches over {len(kernels)} kernel names on "
        f"{out['kernel_streams']} stream(s); the device is busy "
        f"{busy_ms:.3f} ms per {unit}, busy share {out['busy_share']:.3f} "
        f"of the {out['scan_fused_round_ms']:.3f} ms steady {unit} and "
        f"{out['busy_share_profiled']:.3f} of the profiled window's "
        f"{out['profiled_round_ms']:.3f} ms per {unit}; top (ms/{unit}): "
        + "; ".join(f"{k[:70]} {v:.4f}" for k, v in top))
    return out


def union_ms(spans) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def lockstep_summary(lock: dict) -> dict:
    """The gated and printed numbers of a :func:`compare_lockstep` run."""
    return {k: lock[k] for k in (
        "one_round_max", "scan_fused_equals_lockstep",
        "eager_vs_scan_fused", "cudnn_default_g_nondeterminism")}


def clone_state(state):
    """A copy of a trainer's state that a round may update in place."""
    base = getattr(state, "base", state)
    copy = base._replace(
        clients=base.clients._replace(x=base.clients.x.clone(),
                                      z=base.clients.z.clone()),
        server=base.server._replace(y=base.server.y.clone()))
    if base is state:
        return copy
    return state._replace(base=copy, tokens=state.tokens.clone())


def tokens_of(state):
    """The walkers' tokens: ``(K, P)`` for a fleet, y ``(P,)`` else."""
    return state.tokens if hasattr(state, "tokens") else state.server.y


def round_slots(trainer, state, sched, r: int) -> dict:
    """Round ``r``'s live slots as ``state`` holds them: client ids, and
    per slot the token its update reads (y'), x', z' and the gradient at
    x' on the round's draws."""
    import torch

    dev = trainer.device
    flat = torch.as_tensor(sched.idx[r].reshape(-1), dtype=torch.int64,
                           device=dev)
    live = torch.as_tensor(sched.mask[r].reshape(-1) > 0,
                           device=dev).nonzero().squeeze(1)
    base = getattr(state, "base", state)
    if not hasattr(state, "tokens"):
        y = base.server.y.expand(flat.numel(), -1)
    elif sched.mode == "roundrobin":
        y = state.tokens[int(sched.walker[r])].expand(flat.numel(), -1)
    else:
        y = state.tokens.repeat_interleave(sched.idx.shape[-1], dim=0)
    x = base.clients.x[flat]
    batch_idx, keep = trainer.zone_batch_indices(
        flat, torch.as_tensor(sched.keys[r], device=dev))
    _, g = trainer.zone_loss_and_grad(x, flat, batch_idx, keep)
    return {"clients": flat[live], "y": y[live], "x": x[live],
            "z": base.clients.z[flat][live], "g": g[live]}


#: A coordinate's gap counts as more than rounding above this.
ROUNDING_GAP = 1e-6


def compare_lockstep(make, steps: int, leaves, unit: str, hp,
                     label: str) -> dict:
    """Eager (the plain update) and the fused rounds (the kernel: the
    code a ``scan_fused`` window captures) stepped in lockstep from one
    seed, cuDNN deterministic. Held: at every step, one round from the
    eager state through the kernel equals the eager round at
    ``KERNEL_TOL`` (x, z, y or the tokens, κ; under a biased walk with
    the ``iw`` fold); and a ``scan_fused`` run from the same seed equals
    the lockstep fused rounds bit for bit. Printed: that one-round gap
    in y before and after the ``iw`` rescale, and how the two
    trajectories part: their gaps going into each step (y, x', the
    gradients at x'), the live coordinates where sgn(y' − x') differs
    between them, and where x⁺ then parts beyond rounding, by sign
    mismatch, gradient gap (> ``ROUNDING_GAP``·β) or neither. On the
    CNN a last-bit gap in x' moves the gradient by up to ~1e-3 at
    ReLU and max-pool near-ties, and that grows every round, so the
    trajectories' end states are printed against ``EAGER_ATOL``, not
    held to it."""
    import numpy as np
    import torch

    def amax(t) -> float:
        return float(t.abs().max()) if t.numel() else 0.0

    def gap(a, b) -> float:
        return amax(a - b)

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    seed = MAIN["seed"]
    eager, lock = make(), make()
    sched = lock.schedule(steps, np.random.default_rng(seed))
    s_e, s_f = eager.init_state(seed), lock.init_state(seed)
    y_key = "tokens" if hasattr(s_e, "tokens") else "y"
    nondet = gap(round_slots(lock, s_e, sched, 0)["g"],
                 round_slots(lock, s_e, sched, 0)["g"])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    rows = []
    try:
        rng = np.random.default_rng(seed)
        for r in range(steps):
            one = {}
            for fused in (False, True):
                for weighted in (False, True):
                    one[fused, weighted] = leaves(uncaptured_rounds(
                        lock, clone_state(s_e), sched, fused, (r,),
                        weighted))
            e = round_slots(lock, s_e, sched, r)
            f = round_slots(lock, s_f, sched, r)
            flip = torch.sign(e["y"] - e["x"]) != torch.sign(f["y"] - f["x"])
            row = {"iw": (None if sched.iw is None
                          else np.asarray(sched.iw[r]).tolist()),
                   "one_round": {k: gap(one[True, True][k],
                                        one[False, True][k])
                                 for k in one[True, True]},
                   "one_round_y_unweighted": gap(one[True, False][y_key],
                                                 one[False, False][y_key]),
                   "y_in": gap(tokens_of(s_e), tokens_of(s_f)),
                   "x_in": gap(e["x"], f["x"]),
                   "g_in": gap(e["g"], f["g"]),
                   "sign_mismatches": int(flip.sum())}
            del one
            s_e, _ = eager.round(s_e, r, rng)
            s_f = uncaptured_rounds(lock, s_f, sched, True, (r,))
            dx = (getattr(s_e, "base", s_e).clients.x[e["clients"]]
                  - getattr(s_f, "base", s_f).clients.x[f["clients"]]).abs()
            big = dx > ROUNDING_GAP
            kink = (e["g"] - f["g"]).abs() / hp.beta > ROUNDING_GAP
            row.update({"x_out": amax(dx), "x_out_coords": int(big.sum()),
                        "of_them_sign": int((big & flip).sum()),
                        "of_them_gradient": int((big & kink & ~flip).sum()),
                        "of_them_neither": int((big & ~kink & ~flip).sum())})
            rows.append(row)
            log(f"lockstep {label}, {unit[:-1]} {r}: iw {row['iw']}; one "
                f"round from the eager state, kernel vs plain "
                f"{row['one_round']} (y {row['one_round_y_unweighted']:.3g} "
                f"before the iw rescale); the trajectories going in: y "
                f"{row['y_in']:.3g}, x' {row['x_in']:.3g}, gradient "
                f"{row['g_in']:.3g}; sgn(y' − x') differs at "
                f"{row['sign_mismatches']} live coordinates; x⁺ parts by "
                f"> {ROUNDING_GAP:g} at {row['x_out_coords']} "
                f"({row['of_them_sign']} sign mismatches, "
                f"{row['of_them_gradient']} gradient gaps > "
                f"{ROUNDING_GAP:g}·β, {row['of_them_neither']} neither), "
                f"max {row['x_out']:.3g}")
        fused = make()
        s_sf, _ = fused.run_chunk(
            fused.init_state(seed),
            fused.schedule(steps, np.random.default_rng(seed)), "scan_fused")
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    a, b, c = leaves(s_e), leaves(s_sf), leaves(s_f)
    out = {"steps": rows, "cudnn_default_g_nondeterminism": nondet,
           "one_round_max": max(max(r["one_round"].values()) for r in rows),
           "scan_fused_equals_lockstep": all(torch.equal(b[k], c[k])
                                             for k in b),
           "eager_vs_scan_fused": {k: gap(a[k], b[k]) for k in a}}
    log(f"eager vs scan_fused, {label}, {steps} {unit} in lockstep (cuDNN "
        f"deterministic; its default backward twice on one zone's inputs "
        f"differs by {nondet:.3g}): one round from the eager state, kernel "
        f"vs plain, at most {out['one_round_max']:.3g} (held at "
        f"{KERNEL_TOL}); scan_fused equals the lockstep fused rounds "
        f"bitwise {out['scan_fused_equals_lockstep']}; the end states part "
        f"by {out['eager_vs_scan_fused']} (printed beside {EAGER_ATOL})")
    if not (out["scan_fused_equals_lockstep"]
            and out["one_round_max"] <= KERNEL_TOL):
        raise AssertionError(f"eager and scan_fused disagree: {out}")
    return out


# ---------------------------------------------------------------------------
# The lazy client plane: the bounded LRU store on the card (client rows and
# data by slot), DP uploads, telemetry and checkpoints.
# The CNN cells on the store: n = 100 at capacity 40 in windows of 4
# rounds (a window's working set is at most 4·8 + 1 with the padding id);
# the walk touches 21 clients in 20 rounds and 81 in 80, so 80 rounds
# evict (61) and restore (20). The fleet: capacity 50, windows of 2 wall
# steps (at most 2·24 + 1), 30 wall steps (57 evictions, 23 restores).
# The checkpoint saves after 40 rounds, with rows spilled.
LAZY = dict(capacity=40, window=4, rounds=80, fleet_capacity=50,
            fleet_window=2, fleet_steps=30, timed_windows=5,
            fedavg_rounds=3, fedavg_capacity=12, dp_rounds=8, dp_window=4,
            ckpt_rounds=40, check_clients=100_000, check_window=2,
            overhead_clients=2000, overhead_repeats=30, overhead_rounds=32,
            overhead_pct=5.0)


@functools.lru_cache(maxsize=1)
def main_fed(seed: int):
    """The main path's federated data on the host (``FederatedData``)."""
    from repro_torch.data import build_federated, pathological_split
    from repro_torch.data.synthetic_images import make_cifar_like

    imgs, labels = make_cifar_like(MAIN["n_samples"], seed=seed)
    parts = pathological_split(labels, MAIN["n_clients"], seed=seed)
    return build_federated(imgs, labels, parts)


def lazy_rows(trainer, state) -> dict:
    """A lazy run's state in the dense layout, for the clients the walk
    visited: their x/z rows (from their slots or the spill buffer), with
    y, κ and ``visited``."""
    import torch

    store, base = trainer.store, getattr(state, "base", state)
    ids = base.visited.nonzero().squeeze(1).cpu().numpy()
    rows = {"x": [], "z": []}
    for i in ids:
        s = store.slot_arr[i]
        for j, k in enumerate(("x", "z")):
            rows[k].append(getattr(base.clients, k)[s].cpu() if s >= 0
                           else torch.from_numpy(store._spill[int(i)][j]))
    out = {k: torch.stack(v) for k, v in rows.items()}
    out.update(ids=torch.as_tensor(ids), y=base.server.y.cpu(),
               kappa=base.server.kappa.cpu(), visited=base.visited.cpu())
    if hasattr(state, "tokens"):
        out["tokens"] = state.tokens.cpu()
    return out


def dense_rows(state, ids) -> dict:
    base = getattr(state, "base", state)
    out = {"x": base.clients.x[ids].cpu(), "z": base.clients.z[ids].cpu(),
           "ids": ids, "y": base.server.y.cpu(),
           "kappa": base.server.kappa.cpu(), "visited": base.visited.cpu()}
    if hasattr(state, "tokens"):
        out["tokens"] = state.tokens.cpu()
    return out


def replay_store(trainer_cpu, factory, capacity: int, rounds: int,
                 window: int) -> dict:
    """The counters of a CPU store of the port driven over the same
    windows' raw padded ids (the CPU trainer's ``schedule()``)."""
    import numpy as np
    import torch

    from repro_torch.fl.client_store import ClientStore

    store = ClientStore(factory, capacity, device=torch.device("cpu"))
    rows = store.reset((torch.zeros(1),))
    rng = np.random.default_rng(MAIN["seed"])
    for r in range(0, rounds, window):
        sched = trainer_cpu.schedule(window, rng, start_round=r)
        store.ensure(rows, sched.idx.reshape(-1))
    return dict(store.counters)


def timed_windows(trainer, windows: int, window: int, seed: int) -> dict:
    """Steady ms a round of ``scan_fused`` windows (``ensure`` and the
    replay, each window ending in a sync; the schedule outside), and on
    the lazy plane the host ms ``ensure()`` takes a window (its telemetry
    span)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.telemetry import TelemetryRun, read_events

    rng = np.random.default_rng(seed + 7)
    state = trainer.init_state(seed)
    state, _ = trainer.run_chunk(state, trainer.schedule(window, rng),
                                 "scan_fused")
    spent = 0.0
    with tempfile.TemporaryDirectory() as td:
        with TelemetryRun(os.path.join(td, "run"), seed=seed,
                          config={"timed_windows": window}) as tel:
            trainer.set_telemetry(tel)
            try:
                for w in range(windows):
                    sched = trainer.schedule(window, rng,
                                             start_round=(w + 1) * window)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, _ = trainer.run_chunk(state, sched, "scan_fused")
                    torch.cuda.synchronize()
                    spent += time.perf_counter() - t0
            finally:
                trainer.set_telemetry(None)
        ensure_s = [e["seconds"] for e in read_events(tel.events_path)
                    if e["t"] == "phase" and e["name"] == "ensure"]
    out = {"round_ms": spent / (windows * window) * 1e3}
    if ensure_s:
        out["ensure_ms_per_window"] = sum(ensure_s) / len(ensure_s) * 1e3
    return out


def lazy_vs_dense(label: str, make, make_cpu, factory, capacity: int,
                  rounds: int, window: int, update: str, unit: str) -> dict:
    """One cell on both planes from one seed, cuDNN deterministic:
    ``scan_fused`` in windows of ``window`` through ``run_simulation``
    (launch counts exact per round on the lazy run), host columns by
    ``==``, y (the tokens) and every visited client's x/z rows bit for
    bit, the store's counters against a CPU store over the same ids;
    steady ms a round beside dense, ``ensure()``'s host ms and the bytes
    evicted and restored."""
    import torch

    seed = MAIN["seed"]
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        lazy, dense = make(factory, capacity), make(None, None)
        res, counts, peak, losses, _ = drive(lazy, rounds, seed, update,
                                             f"{label} (lazy)", window)
        traffic = {"evicted_bytes": lazy.store.evicted_bytes,
                   "restored_bytes": lazy.store.restored_bytes}
        got = lazy_rows(lazy, lazy._carry)
        counters = dict(lazy.store.counters)
        d_res, _, d_peak, d_losses, _ = drive(dense, rounds, seed, update,
                                              f"{label} (dense)", window)
        want = dense_rows(dense._carry, got["ids"].to(dense.device))
        want["ids"] = want["ids"].cpu()
        times = {"lazy": timed_windows(lazy, LAZY["timed_windows"], window,
                                       seed),
                 "dense": timed_windows(dense, LAZY["timed_windows"],
                                        window, seed)}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    replay = replay_store(make_cpu(), factory, capacity, rounds, window)
    equal = {k: bool(torch.equal(got[k], want[k])) for k in got}
    checks = {
        "host columns equal": host_columns(res.round_metrics)
        == host_columns(d_res.round_metrics),
        "losses equal": losses == d_losses,
        "state equal": all(equal.values()),
        "counters equal the CPU store's": counters == replay,
        "misses, evictions, restores > 0": all(
            counters[k] > 0 for k in ("misses", "evictions", "restores")),
    }
    log(f"lazy {label}: n = {lazy.n_clients}, capacity {capacity}, "
        f"{rounds} {unit}s of scan_fused in windows of {window}, cuDNN "
        f"deterministic; wrapper counts {counts['counts']}, launches run "
        f"{counts['ran']} in {counts['replays']} replay(s); store counters "
        f"{counters} (a CPU store over the same ids: {replay}); "
        f"{len(got['ids'])} visited clients' x/z, y, κ, visited equal the "
        f"dense run bit for bit: {equal}; losses equal {checks['losses equal']}"
        f"; evicted {traffic['evicted_bytes'] / 1e6:.2f} MB, restored "
        f"{traffic['restored_bytes'] / 1e6:.2f} MB; steady "
        f"{times['lazy']['round_ms']:.3f} ms/{unit} lazy (ensure "
        f"{times['lazy']['ensure_ms_per_window']:.3f} host ms a window of "
        f"{window}) against {times['dense']['round_ms']:.3f} dense; peak "
        f"allocated {peak / 2**30:.3f} GiB lazy, {d_peak / 2**30:.3f} dense")
    if not all(checks.values()):
        raise AssertionError(f"lazy {label}: {checks}")
    return {"launches": counts["counts"], "launches_run": counts["ran"],
            "graph_replays": counts["replays"], "counters": counters,
            **traffic, "steady": times, "peak_gib": peak / 2**30,
            "dense_peak_gib": d_peak / 2**30, "checks": checks}


def fedavg_lazy(device, model, data, factory) -> dict:
    """FedAvg on the store (capacity below the cohorts' union): a few CNN
    rounds equal to the dense run on the host columns by ``==``; the
    global model's gap printed."""
    import numpy as np
    import torch

    cfg = CNN_BASELINES
    kw = dict(clients_per_round=cfg["clients_per_round"], lr=cfg["lr"])
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        runs = {}
        for plane, dat, extra in (
                ("dense", data, {}),
                ("lazy", factory,
                 {"store_capacity": LAZY["fedavg_capacity"]})):
            tr = make_baseline("fedavg", model, dat, device, **kw, **extra)
            rng = np.random.default_rng(MAIN["seed"])
            state, metrics = tr.init_state(MAIN["seed"]), []
            for r in range(LAZY["fedavg_rounds"]):
                state, m = tr.round(state, r, rng)
                metrics.append(m)
            runs[plane] = (tr, state.w.clone(), metrics)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    lazy = runs["lazy"][0]
    gap = float((runs["lazy"][1] - runs["dense"][1]).abs().max())
    equal = runs["lazy"][2] == runs["dense"][2]
    log(f"lazy fedavg: {LAZY['fedavg_rounds']} CNN rounds, cohorts of "
        f"{kw['clients_per_round']}, capacity {LAZY['fedavg_capacity']}: "
        f"round metrics equal the dense run's {equal}; store counters "
        f"{lazy.store.counters}; global model gap to dense {gap:.3g} "
        f"(bitwise {gap == 0.0})")
    if not equal or not lazy.store.counters["evictions"]:
        raise AssertionError(f"lazy fedavg: {runs['lazy'][2]} vs "
                             f"{runs['dense'][2]}, {lazy.store.counters}")
    return {"round_metrics_equal": equal, "w_gap": gap,
            "counters": dict(lazy.store.counters)}


def lazy_check_subprocess(device) -> dict:
    """``benchmarks/scan_scaling_torch.py --lazy-check`` at n = 100,000 in
    its own process (its peak RSS is its own): windows of 2 rounds of
    ``scan_fused`` with prefetch off and on (bit for bit equal) and of
    ``scan``, every window's host columns against the CPU's
    ``schedule()``."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "benchmarks.scan_scaling_torch",
         "--lazy-check", "--lazy-clients", str(LAZY["check_clients"]),
         "--lazy-rounds", str(LAZY["check_window"]),
         "--device", str(device)],
        cwd=HERE, capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": os.path.join(HERE, "src")})
    if out.returncode != 0:
        raise AssertionError(f"lazy check failed ({out.returncode}): "
                             f"{out.stdout[-2000:]} {out.stderr[-4000:]}")
    row = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"lazy mlr-synthetic-lr-n{row['n']}: windows of {row['rounds']} "
        f"rounds in {time.perf_counter() - t0:.1f} s (one process): "
        + "; ".join(f"{k} {row[k]['us_per_round']:.0f} µs a round (windows "
                    f"{[round(s, 3) for s in row[k]['window_s']]} s), peak "
                    f"device {row[k]['peak_device_mb']} MB, peak RSS "
                    f"{row[k]['peak_rss_mb']:.0f} MB, counters "
                    f"{row[k]['counters']}"
                    for k in ("scan_fused", "scan_fused_prefetch", "scan"))
        + f"; checks {row['checks']}")
    return row


def dp_phase(device, model, data, hp) -> dict:
    """DP uploads (``dp_clip=1.0``, ``dp_noise=1.0``): on the CNN cell the
    captured ``scan`` windows equal eager rounds bit for bit (cuDNN
    deterministic); one MLR round on the card against the CPU at 1e-6;
    ``scan_fused`` refuses. Returns the DP path's ``threefry_bits``
    launches a round."""
    import numpy as np
    import torch

    from repro_torch.fl.base import DeviceData
    from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer
    from repro_torch.models.small import get_model

    seed, dp = MAIN["seed"], dict(dp_clip=1.0, dp_noise=1.0)
    rounds, window = LAZY["dp_rounds"], LAZY["dp_window"]

    def make(mdl=model, dat=data, dev=device):
        return RWSADMMTrainer(mdl, dat, hp, batch_size=MAIN["batch"],
                              zone_size=MAIN["zone"], solver="closed_form",
                              seed=seed, device=dev, **dp)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        eager, scan = make(), make()
        rng = np.random.default_rng(seed)
        s_e = eager.init_state(seed)
        for r in range(rounds):
            s_e, _ = eager.round(s_e, r, rng)
        rng = np.random.default_rng(seed)
        s_s = scan.init_state(seed)
        zero_launch_counts()
        for r in range(0, rounds, window):
            s_s, _ = scan.run_chunk(s_s, scan.schedule(window, rng,
                                                       start_round=r), "scan")
        torch.cuda.synchronize()
        counts = launch_counts()
        ran = window_launches(scan)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    a, b = state_leaves(s_e), state_leaves(s_s)
    captured_equal = {k: bool(torch.equal(a[k], b[k])) for k in a}
    captured = [w.captured for w in scan.windows.values()]
    bits_per_round = sum(c["threefry_bits"] for c in captured) // window
    # One MLR round on the card against the CPU.
    parity_data, shape = parity_mlr_data(device)
    cpu_data = DeviceData(*(t.cpu() for t in parity_data))
    states = []
    for dev, dat in ((device, parity_data), ("cpu", cpu_data)):
        tr = make(get_model("mlr", shape), dat, dev)
        st, _ = tr.round(tr.init_state(seed), 0, np.random.default_rng(seed))
        states.append({k: v.cpu() for k, v in state_leaves(st).items()})
    gaps = {k: float((states[0][k].double() - states[1][k].double())
                     .abs().max()) for k in ("x", "z", "y")}
    tr = make()
    try:
        tr.run_chunk(tr.init_state(seed),
                     tr.schedule(2, np.random.default_rng(seed)), "scan_fused")
        refused = ""
    except ValueError as e:
        refused = str(e)
    checks = {"captured scan equals eager": all(captured_equal.values()),
              "card round equals the CPU's at 1e-6":
                  all(v <= 1e-6 for v in gaps.values()),
              "scan_fused refuses": "does not support DP" in refused}
    log(f"dp: CNN, {rounds} rounds, captured scan (windows of {window}) vs "
        f"eager bit for bit {captured_equal}; the window captured "
        f"{captured} ({bits_per_round} threefry_bits launches a round: "
        f"fold_in, the zone's split, the leaves' split, one normal a "
        f"leaf), wrapper counts {counts}; one MLR round card vs CPU, max "
        f"abs gap {gaps} (held at 1e-6); scan_fused: {refused!r}")
    if not all(checks.values()):
        raise AssertionError(f"dp: {checks}")
    return {"captured_equal": captured_equal, "card_vs_cpu": gaps,
            "threefry_bits_per_round": bits_per_round, "launches": counts,
            "launches_run": ran, "checks": checks}


def parity_mlr_data(device):
    from benchmarks import table1_torch

    return table1_torch.mnist_like_fed(n_clients=PARITY["n_clients"],
                                       n_samples=PARITY["n_samples"],
                                       device=device)


def overhead_subprocess() -> dict:
    """``benchmarks/telemetry_overhead_torch.py`` at n = 2,000 in its own
    process, as its users run it, over ``LAZY["overhead_repeats"]``
    interleaved off/on pairs; its own gate off (the caller gates). A pair
    has a standard deviation of 10–14 % on the card machine's host, on
    the arms' CPU time as on the wall clock (``scripts/overhead_probe.py``;
    the upper end with a CUDA context in the process): the median of 30
    pairs in a fresh process has about 2.5 %."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        rows_path = os.path.join(td, "rows.json")
        out = subprocess.run(
            [sys.executable, "-m", "benchmarks.telemetry_overhead_torch",
             "--clients", str(LAZY["overhead_clients"]),
             "--rounds", str(LAZY["overhead_rounds"]),
             "--repeats", str(LAZY["overhead_repeats"]),
             "--assert-overhead-pct", "-1", "--out", rows_path],
            cwd=HERE, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": os.path.join(HERE, "src")})
        if out.returncode != 0:
            raise AssertionError(f"overhead twin failed ({out.returncode}): "
                                 f"{out.stdout[-2000:]} {out.stderr[-4000:]}")
        with open(rows_path) as f:
            rows = {r["name"].rsplit("/", 1)[1]: r
                    for r in json.load(f)["rows"]}
    on, off = rows["on"], rows["off"]
    return {"n": on["n"], "pairs": on["pairs"], "off_us": off["us_per_round"],
            "on_us": on["us_per_round"], "overhead_pct": on["overhead_pct"],
            "pair_pct": on["pair_pct"], "trace_pct": on["trace_pct"]}


def telemetry_phase(make, factory, update: str, off: dict) -> dict:
    """Step a's lazy cell again with a telemetry run attached: equal to
    the unrecorded run (``off``) bit for bit, with the same captured and
    replay counts; the report renders; then the overhead twin at
    n = 2,000 (the median pair's on/off at most ``LAZY["overhead_pct"]``
    %)."""
    import torch

    from repro_torch.telemetry import TelemetryRun, read_events
    from repro_torch.telemetry.report import render_report

    seed = MAIN["seed"]
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    run_dir = os.path.join(HERE, "runs", "telemetry_lazy")
    shutil.rmtree(run_dir, ignore_errors=True)   # events append
    try:
        tr = make(factory, LAZY["capacity"])
        with TelemetryRun(run_dir, seed=seed,
                          config={"cell": "cnn-cifar-n100-lazy"}) as tel:
            res, counts, _, losses, _ = drive(
                tr, LAZY["rounds"], seed, update, "telemetry on",
                LAZY["window"], telemetry=tel)
        rows = lazy_rows(tr, tr._carry)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    same = {k: bool(torch.equal(rows[k], off["rows"][k])) for k in rows}
    wins = {str(k): (w.captured, w.replays) for k, w in tr.windows.items()}
    phases = [e for e in read_events(tel.events_path) if e["t"] == "phase"]
    report = render_report(run_dir)
    over = overhead_subprocess()
    checks = {"state equal": all(same.values()),
              "metrics equal": res.round_metrics == off["metrics"],
              "captured and replays equal": wins == off["windows"],
              "window spans carry device time": all(
                  "device_seconds" in p for p in phases
                  if p["name"] == "scan_chunk"),
              "overhead within bound":
                  over["overhead_pct"] <= LAZY["overhead_pct"]}
    log(f"telemetry on the lazy cell: state equal {same}, metrics equal "
        f"{checks['metrics equal']}, windows (captured, replays) {wins}; "
        f"{len(phases)} phase spans; report:\n"
        + "\n".join(report.splitlines()[:4] + ["..."]
                    + [ln for ln in report.splitlines()
                       if ln.startswith(("scan_chunk", "ensure", "eval"))])
        + f"\ntelemetry overhead at n = {over['n']}: off "
        f"{over['off_us']:.0f} µs a round, on {over['on_us']:.0f} "
        f"(medians of {over['pairs']} pairs of {LAZY['overhead_rounds']} "
        f"rounds); the median pair's on/off "
        f"{over['overhead_pct']:+.2f} % (bound {LAZY['overhead_pct']} %; "
        f"pairs {[round(x, 2) for x in over['pair_pct']]}); the trace "
        f"alone {over['trace_pct']:.3f} % of a round")
    if not all(checks.values()):
        raise AssertionError(f"telemetry: {checks}")
    return {"checks": checks, "overhead": over, "phase_spans": len(phases)}


def checkpoint_phase(make, factory) -> dict:
    """Step a's lazy cell saved mid-run with spilled rows (state and store
    to npz), restored into a fresh trainer whose host control plane
    replays the first half, and continued: equal to the uninterrupted run
    bit for bit (cuDNN deterministic)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import load_client_store, load_pytree, \
        save_client_store, save_pytree

    seed, half, window = MAIN["seed"], LAZY["ckpt_rounds"], LAZY["window"]
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False

    def windows(tr, state, rng, start, stop):
        losses = []
        for r in range(start, stop, window):
            state, st = tr.run_chunk(state, tr.schedule(window, rng,
                                                        start_round=r),
                                     "scan_fused")
            losses += st["train_loss"].tolist()
        return state, losses
    try:
        whole = make(factory, LAZY["capacity"])
        s_w, l_w = windows(whole, whole.init_state(seed),
                           np.random.default_rng(seed), 0, 2 * half)
        first = make(factory, LAZY["capacity"])
        rng = np.random.default_rng(seed)
        s_1, l_1 = windows(first, first.init_state(seed), rng, 0, half)
        spilled = len(first.store.spilled_ids)
        with tempfile.TemporaryDirectory() as td:
            save_pytree(os.path.join(td, "state.npz"), s_1, step=half)
            save_client_store(os.path.join(td, "store.npz"), first.store)
            fresh = make(factory, LAZY["capacity"])
            rng2 = np.random.default_rng(seed)
            for r in range(0, half, window):     # the host side replayed
                fresh.schedule(window, rng2, start_round=r)
            state = load_pytree(os.path.join(td, "state.npz"),
                                fresh.init_state(seed))
            load_client_store(os.path.join(td, "store.npz"), fresh.store)
        s_2, l_2 = windows(fresh, state, rng2, half, 2 * half)
        got, want = lazy_rows(fresh, s_2), lazy_rows(whole, s_w)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    same = {k: bool(torch.equal(got[k], want[k])) for k in got}
    checks = {"spilled at the save": spilled > 0,
              "losses equal": l_1 + l_2 == l_w,
              "state equal": all(same.values())}
    log(f"checkpoint: saved after {half} rounds with {spilled} spilled "
        f"clients, restored into a fresh trainer, {half} more rounds: "
        f"losses equal {checks['losses equal']}, state equal {same}")
    if not all(checks.values()):
        raise AssertionError(f"checkpoint: {checks}")
    return {"spilled": spilled, "checks": checks}


def phase_lazy(device, model, data, hp) -> dict:
    """The lazy client plane on the card (steps a–g): the full-width CNN
    single walker and K = 3 fleet on the store against their dense runs,
    FedAvg on the store, the n = 100,000 MLR cell in its own process, DP
    uploads, telemetry on ≡ off, a checkpoint restored and continued."""
    import torch

    from repro_torch.data import factory_from_federated
    from repro_torch.fl.base import DeviceData

    seed = MAIN["seed"]
    factory = factory_from_federated(main_fed(seed))
    cpu_data = DeviceData(*(t.cpu() for t in data))

    def single(fac, capacity, dev=device, dat=data):
        if fac is None:
            return make_trainer(model, dat, hp, dev, seed)
        from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer

        return RWSADMMTrainer(model, fac, hp, batch_size=MAIN["batch"],
                              zone_size=MAIN["zone"], solver="closed_form",
                              seed=seed, device=dev, store_capacity=capacity)

    def fleet(fac, capacity, dev=device, dat=data):
        if fac is None:
            return make_fleet(model, dat, hp, dev, seed)
        from repro_torch.fl.fleet_trainer import FleetRWSADMMTrainer

        return FleetRWSADMMTrainer(
            model, fac, hp, n_walkers=FLEET["n_walkers"],
            sync_every=FLEET["sync_every"], fleet_mode="simultaneous",
            batch_size=MAIN["batch"], zone_size=MAIN["zone"],
            solver="closed_form", seed=seed, device=dev,
            store_capacity=capacity)

    out = {}
    out["single walker"] = lazy_vs_dense(
        "cnn-cifar-n100-lazy", single,
        lambda: single(None, None, "cpu", cpu_data), factory,
        LAZY["capacity"], LAZY["rounds"], LAZY["window"], "zone_update",
        "round")
    out["fleet simultaneous"] = lazy_vs_dense(
        "cnn-cifar-n100-lazy K = 3 fleet", fleet,
        lambda: fleet(None, None, "cpu", cpu_data), factory,
        LAZY["fleet_capacity"], LAZY["fleet_steps"], LAZY["fleet_window"],
        "multizone_update", "wall step")
    out["fedavg"] = fedavg_lazy(device, model, data, factory)
    out["n100000"] = lazy_check_subprocess(device)
    out["dp"] = dp_phase(device, model, data, hp)
    # The unrecorded run of step a, for telemetry on ≡ off.
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        tr = single(factory, LAZY["capacity"])
        res, *_ = drive(tr, LAZY["rounds"], seed, "zone_update",
                        "telemetry off", LAZY["window"])
        off = {"rows": lazy_rows(tr, tr._carry),
               "metrics": res.round_metrics,
               "windows": {str(k): (w.captured, w.replays)
                           for k, w in tr.windows.items()}}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    out["telemetry"] = telemetry_phase(single, factory, "zone_update", off)
    out["checkpoint"] = checkpoint_phase(single, factory)
    return out


# ---------------------------------------------------------------------------
# RecurrentGemma-9B serving (the model zoo's slice): its two kernels and
# the full-width path.
LM_ARCH = "recurrentgemma-9b"
SERVE = dict(batch=4, prompt=2040, gen=16, seed=0)
# Flash decode vs its plain masked softmax, as (atol, rtol). Both compute
# in fp32 and differ only in the order of the sums (~1e-6 relative), then
# round the output to the inputs' type. fp32: the reference's 1e-5
# (tests/test_kernels.py). bf16: the two fp32 results may round one bf16
# ulp apart (at most 2^-7 of the value), so rtol 1e-2, and atol 1e-3 for
# outputs near zero. At the serving shape the outputs have an RMS of
# ~0.036 (softmax over 2048 N(0, 1) scores) and the kernel reads
# ~2.4e-4; a dropped 128-key block moves them by ~1e-2. One key more or
# fewer moves them by ~1e-3, which the fp32 rows at 1e-5 catch.
FLASH_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-3, 1e-2)}
# Decode logits vs a teacher-forced ``apply`` over the same 2056 tokens,
# relative RMS error per position. In bf16 the two paths round the same
# math at different places (cuBLAS tiles a 1-token product otherwise than
# a 2040-token one, the flash kernel sums in another order than the
# chunked softmax), and those ulps (2^-8 relative) compound over the
# layers: the H100 reads 1.42-1.64e-2 on RecurrentGemma's 38, 1.35e-2 on
# its 19 and on gemma3-12b's 48, 3.7e-3-7.7e-3 on the 2-layer cuts.
# 5e-2 leaves 3x room over that; it fails arithmetic in a coarser type or
# a fault of order one, but not a fault in the ring: with random weights
# the attention spreads over ~2048 keys, so a key more, fewer or stale,
# or a RoPE position one too far, read 1.66-1.90e-2 on the H100
# (tests/test_torch_teacher_probe.py). The fp32 pass holds the ring:
# there the paths agree to float rounding (3.5e-6 on the H100; gemma3-
# 12b's first pattern 2.1e-6), and those four faults read 2.7e-4 (one
# key too many before the wrap) to 7.8e-3; 1e-4 lies between.
TEACHER_REL_RMS = {"bfloat16": 5e-2, "float32": 1e-4}


def _rel_rms(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def lm_kernel_bound(nbytes: int, flops: int, card: str) -> dict:
    rate, rate_src = hbm_rate(card)
    bytes_ms = nbytes / rate * 1e3
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), bytes=nbytes,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_rate=rate_src)


def check_rglru_scan(shape, device, card: str, time_it: bool) -> dict:
    """The scan kernel against its plain loop: bit for bit, and the path
    that launched."""
    import torch

    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    gen = torch.Generator(device=device).manual_seed(sum(shape))

    def inputs():
        return (torch.sigmoid(torch.randn(shape, generator=gen,
                                          device=device)),
                torch.randn(shape, generator=gen, device=device))
    a, b = inputs()
    before = dict(ops.rglru_scan.launches_by_path)
    got = ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    path = [p for p in ops.PATHS
            if ops.rglru_scan.launches_by_path[p] != before[p]]
    want = rglru_scan_ref(a, b)
    row = {"shape": "B={} S={} D={}".format(*shape),
           "path": path[0] if len(path) == 1 else path,
           "planned": ops.plan(shape),
           "max_abs_err": float((got - want).abs().max()),
           "bitwise": bool(torch.equal(got, want))}
    if time_it:
        bsz, s, d = shape
        # Two input sets (each 2.4 times the L2 already) in turn: cold;
        # one set again and again: warm.
        sets = [(a, b), inputs()]
        cold = device_time_ms([lambda a=a, b=b: ops.rglru_scan(a, b)
                               for a, b in sets], 10, kernels=1)
        warm = device_time_ms([lambda: ops.rglru_scan(a, b)], 10, kernels=1)
        plain = device_time_ms([lambda: rglru_scan_ref(a, b)], 1,
                               graph=False)
        row.update(ms=cold["profiler"], ms_warm=warm["profiler"],
                   graph_ms=cold["graph"], graph_ms_warm=warm["graph"],
                   records_lost=[cold["records_lost"], warm["records_lost"]],
                   plain_ms=plain["profiler"],
                   plain_wall_ms=cuda_time_ms(lambda: rglru_scan_ref(a, b),
                                              2, warmup=1),
                   config=dict(zip(("lanes", "steps", "stages",
                                    "smem_bytes", "bwd_smem_bytes"),
                                   ops.staged_geometry())))
        # Read a and b, write h, fp32; a multiply and an add per element.
        row.update(lm_kernel_bound(3 * bsz * s * d * 4, 2 * bsz * s * d,
                                   card))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    log(f"kernel rglru_scan {row['shape']}: path {row['path']} (planned "
        f"{row['planned']}) max_abs_err {row['max_abs_err']} bitwise "
        f"{row['bitwise']}"
        + (f" device ms cold {row['ms']:.4f} warm {row['ms_warm']:.4f} "
           f"graph cold {row['graph_ms']:.4f} warm "
           f"{row['graph_ms_warm']:.4f} (profiler records lost cold, warm "
           f"{row['records_lost']}) plain device ms "
           f"{row['plain_ms']:.3f} (wall {row['plain_wall_ms']:.3f}) "
           f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']}, "
           f"{row['bound_rate']}) share {row['share_of_bound']:.3f} "
           f"library none config {row['config']}" if time_it else ""))
    if not row["bitwise"] or row["path"] != row["planned"]:
        raise AssertionError(f"rglru_scan differs from its plain loop or "
                             f"took another path than planned: {row}")
    return row


#: the backward's gradient through the Function against autograd through
#: the plain forward loop on the card: the same multiplies and adds, so
#: they agree to float rounding (fp32)
SCAN_GRAD_TOL = dict(atol=1e-6, rtol=1e-5)


def offset_view(t):
    """``t``'s values in a view one float past an aligned start, which bulk
    copies cannot take."""
    import torch

    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = out[1:].view(t.shape)
    out.copy_(t)
    return out


def check_rglru_scan_bwd(shape, device, card: str, time_it: bool,
                         misaligned: bool = False,
                         plain_of: dict | None = None) -> dict:
    """The scan's backward against its plain reverse loop, bit for bit, on
    the path it plans (``staged`` where D % 4 == 0), or with
    ``misaligned`` on a's view one float off, which must take ``loop``;
    with ``time_it`` also timed cold and warm beside its bound and the
    plain loop (``plain_of``: the plain loop's times of a row at the same
    shape in this run, taken over), and (on the aligned path) the
    Function's gradient (the forward kernel, then the backward kernel)
    held against autograd through the plain forward loop at
    ``SCAN_GRAD_TOL``."""
    import torch

    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                    rglru_scan_ref)

    gen = torch.Generator(device=device).manual_seed(sum(shape) + 1)

    def inputs():
        a = torch.sigmoid(torch.randn(shape, generator=gen, device=device))
        b, dh = (torch.randn(shape, generator=gen, device=device)
                 for _ in range(2))
        with torch.no_grad():
            h = ops.rglru_scan(a, b)
        return (offset_view(a) if misaligned else a), b, h, dh
    a, b, h, dh = inputs()
    planned = "loop" if misaligned else ops.plan(shape)
    before = dict(ops.rglru_scan_bwd.launches_by_path)
    da, db = ops.rglru_scan_bwd(a, h, dh)
    torch.cuda.synchronize()
    launched = {p: n - before[p]
                for p, n in ops.rglru_scan_bwd.launches_by_path.items()}
    path = [p for p, n in launched.items() if n]
    want = rglru_scan_bwd_ref(a, h, dh)
    row = {"shape": "B={} S={} D={}".format(*shape)
           + (", a one float off" if misaligned else ""),
           "path": path[0] if len(path) == 1 else path, "planned": planned,
           "max_abs_err": max(float((g - w).abs().max())
                              for g, w in zip((da, db), want)),
           "bitwise": bool(torch.equal(da, want[0])
                           and torch.equal(db, want[1])),
           "launched": sum(launched.values())}
    del want
    if time_it:
        bsz, s, d = shape
        # Two input sets (each 335 MB at the training shape, well over the
        # L2) in turn: cold; one set again and again: warm.
        a2, _, h2, dh2 = inputs()
        sets = [(a, h, dh), (a2, h2, dh2)]
        cold = device_time_ms([lambda t=t: ops.rglru_scan_bwd(*t)
                               for t in sets], 10, kernels=1)
        warm = device_time_ms([lambda: ops.rglru_scan_bwd(a, h, dh)], 10,
                              kernels=1)
        if plain_of is None:
            plain_of = {
                "plain_ms": device_time_ms(
                    [lambda: rglru_scan_bwd_ref(a, h, dh)], 1,
                    graph=False)["profiler"],
                "plain_wall_ms": cuda_time_ms(
                    lambda: rglru_scan_bwd_ref(a, h, dh), 2, warmup=1)}
        row.update(ms=cold["profiler"], ms_warm=warm["profiler"],
                   graph_ms=cold["graph"], graph_ms_warm=warm["graph"],
                   records_lost=[cold["records_lost"], warm["records_lost"]],
                   plain_ms=plain_of["plain_ms"],
                   plain_wall_ms=plain_of["plain_wall_ms"],
                   library_ms=None)
        # Read a, h and dh, write da and db, fp32; a multiply and an add
        # for g and a multiply for da per element.
        row.update(lm_kernel_bound(5 * bsz * s * d * 4, 3 * bsz * s * d,
                                   card))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        del sets, a2, h2, dh2
    if time_it and not misaligned:
        # The Function's gradient against autograd through the plain loop.
        ta, tb = (t.clone().requires_grad_() for t in (a, b))
        ops.rglru_scan(ta, tb).backward(dh)
        pa, pb = (t.clone().requires_grad_() for t in (a, b))
        rglru_scan_ref(pa, pb).backward(dh)
        torch.cuda.synchronize()
        row["function_vs_autograd"] = {
            "max_abs_err": max(float((g.grad - w.grad).abs().max())
                               for g, w in ((ta, pa), (tb, pb))),
            "ok": all(torch.allclose(g.grad, w.grad, **SCAN_GRAD_TOL)
                      for g, w in ((ta, pa), (tb, pb))),
            **SCAN_GRAD_TOL}
        row["config"] = dict(zip(("lanes", "steps", "stages", "smem_bytes",
                                  "bwd_smem_bytes"), ops.staged_geometry()))
        del ta, tb, pa, pb
    log(f"kernel rglru_scan_bwd {row['shape']}: path {row['path']} "
        f"(planned {row['planned']}) max_abs_err {row['max_abs_err']} "
        f"bitwise {row['bitwise']} launches {row['launched']}"
        + (f" device ms cold {row['ms']:.4f} warm {row['ms_warm']:.4f} "
           f"graph cold {row['graph_ms']:.4f} warm "
           f"{row['graph_ms_warm']:.4f} (profiler records lost cold, warm "
           f"{row['records_lost']}) plain device ms "
           f"{row['plain_ms']:.3f} (wall {row['plain_wall_ms']:.3f}) "
           f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']}, "
           f"{row['bound_rate']}) share {row['share_of_bound']:.3f} "
           f"library none" if time_it else "")
        + (f"; config {row['config']}; Function vs autograd through the "
           f"plain loop {row['function_vs_autograd']}"
           if "function_vs_autograd" in row else ""))
    if not row["bitwise"] or row["launched"] != 1 or \
            row["path"] != planned or not row.get(
                "function_vs_autograd", {"ok": True})["ok"]:
        raise AssertionError(f"rglru_scan_bwd differs from its plain loop, "
                             f"took another path than planned or launched "
                             f"otherwise than once: {row}")
    return row


FLASH_COLD_SETS = 10   # serving-shape (q, k, v) sets: 84 MB, over the L2


def check_flash_decode(b, h, kv, hd, s, lengths, window, dtype: str, device,
                       card: str, time_it: bool) -> dict:
    """The flash-decode kernel against the plain masked softmax and the
    split reference at its keys per block; timed cold and warm beside its
    bound and one SDPA call on the same inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import ops
    from repro_torch.kernels.flash_decode.ref import (flash_decode_ref,
                                                      flash_decode_split_ref)

    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=device).manual_seed(b * s + h + hd)

    def inputs():
        q = torch.randn(b, h, hd, generator=gen, device=device).to(tdt)
        k, v = (torch.randn(b, s, kv, hd, generator=gen,
                            device=device).to(tdt) for _ in range(2))
        return q, k, v
    q, k, v = inputs()
    length = torch.tensor(lengths, dtype=torch.int32, device=device)
    split = ops.keys_per_block()
    before = ops.flash_decode.launches
    got = ops.flash_decode(q, k, v, length, window=window)
    torch.cuda.synchronize()
    want = flash_decode_ref(q, k, v, length, window=window)
    split_want = flash_decode_split_ref(q, k, v, length, window=window,
                                        split=split)
    atol, rtol = FLASH_TOL[dtype]
    row = {"shape": f"B={b} H={h} K={kv} hd={hd} S={s} length={lengths} "
                    f"window={window} {dtype}",
           "split": split,
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "max_abs_err_split_ref": float(
               (got.float() - split_want.float()).abs().max()),
           "atol": atol, "rtol": rtol,
           "ok": bool(ops.flash_decode.launches == before + 1
                      and all(torch.allclose(got.float(), w.float(),
                                             atol=atol, rtol=rtol)
                              for w in (want, split_want)))}
    if time_it:
        sets = [(q, k, v)] + [inputs() for _ in range(FLASH_COLD_SETS - 1)]
        pos = torch.arange(s, device=device)
        valid = pos[None] < length[:, None]
        if window is not None:
            valid &= pos[None] >= length[:, None] - window
        mask = valid[:, None, None, :]

        def sdpa(q, k, v):   # GQA with the same length mask: yardstick only
            return F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        def timed(call, graph=True):
            cold = device_time_ms([lambda t=t: call(*t) for t in sets], 20,
                                  graph)
            warm = device_time_ms([lambda: call(q, k, v)], 200 if graph
                                  else 20, graph)
            return cold, warm
        kern = timed(lambda q, k, v: ops.flash_decode(q, k, v, length,
                                                      window=window))
        lib = timed(sdpa)
        plain = timed(lambda q, k, v: flash_decode_ref(q, k, v, length,
                                                       window=window),
                      graph=False)
        log(f"flash_decode device ms by kernel, cold: "
            f"{kern[0]['by_kernel']}; sdpa: {lib[0]['by_kernel']}")
        row.update(ms=kern[0]["profiler"], ms_warm=kern[1]["profiler"],
                   graph_ms=kern[0]["graph"], graph_ms_warm=kern[1]["graph"],
                   kernels_per_call=kern[0]["kernels_per_call"],
                   library_ms=lib[0]["profiler"],
                   library_ms_warm=lib[1]["profiler"],
                   library_graph_ms=lib[0]["graph"],
                   library_graph_ms_warm=lib[1]["graph"],
                   plain_ms=plain[0]["profiler"],
                   plain_ms_warm=plain[1]["profiler"],
                   library_max_abs_err=float(
                       (sdpa(q, k, v)[:, :, 0].float() - want.float())
                       .abs().max()))
        row["config"] = {
            "split": split, "threads": 256,
            "smem_bytes": ops.smem_bytes(hd, q.element_size()),
            "blocks": -(-s // split) * b * kv}
        # The valid keys' K and V rows, q and the output, read or written
        # once; QK and PV are two multiply-adds per element.
        n_valid = int(valid.sum())
        elem = q.element_size()
        row.update(lm_kernel_bound(
            2 * n_valid * kv * hd * elem + 2 * b * h * hd * elem,
            4 * n_valid * (h // kv) * kv * hd, card))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    log(f"kernel flash_decode {row['shape']}: split {split} max_abs_err "
        f"{row['max_abs_err']:.3g} (split ref "
        f"{row['max_abs_err_split_ref']:.3g}; atol {atol}, rtol {rtol})"
        + (f" device ms cold {row['ms']:.5f} warm {row['ms_warm']:.5f} "
           f"({row['kernels_per_call']:.0f} kernels a call), graph cold "
           f"{row['graph_ms']:.5f} warm {row['graph_ms_warm']:.5f}; sdpa "
           f"device ms cold {row['library_ms']:.5f} warm "
           f"{row['library_ms_warm']:.5f} graph cold "
           f"{row['library_graph_ms']:.5f} warm "
           f"{row['library_graph_ms_warm']:.5f} (max_abs_err "
           f"{row['library_max_abs_err']:.3g}); plain device ms cold "
           f"{row['plain_ms']:.4f} warm {row['plain_ms_warm']:.4f}; "
           f"bound_ms {row['bound_ms']:.5f} "
           f"({row['bound_by']}, {row['bound_rate']}) share cold "
           f"{row['share_of_bound']:.3f} config {row['config']}"
           if time_it else ""))
    if not row["ok"]:
        raise AssertionError(f"flash_decode disagrees with its plain "
                             f"version: {row}")
    return row


def phase_lm_kernels(device, card: str) -> dict:
    """The model-zoo kernels at the serving path's shapes (the scan's
    backward at the training step's; timed first rows) and at odd ones:
    S and D tails, the scan's register-loop path,
    G < 16, short head dims (every remainder of hd mod 32 after the
    tensor-core steps: 0, 8, 16, 24), lengths below S, a row with no
    valid key, windows that leave whole chunks masked."""
    full_len = [2048] * 4
    seconds, t0 = {}, time.perf_counter()

    def lap(part):
        nonlocal t0
        seconds[part] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
    # the serve shape (timed), the training step's (timed), odd ones
    scan = [check_rglru_scan((4, 2040, 4096), device, card, time_it=True),
            check_rglru_scan(RG_TRAIN_SCAN, device, card, time_it=True),
            check_rglru_scan((2, 1000, 130), device, card, time_it=False),
            check_rglru_scan((3, 129, 100), device, card, time_it=False)]
    lap("rglru_scan")
    # the training step's shape first (timed on both paths: staged, then
    # the loop on a one float off beside the same plain timing), then the
    # serve shape and odd ones: D not a multiple of 4 or 32, S of 1 and 77
    # (the ring's short last stage), B = 1; each D % 4 == 0 shape on both
    # paths
    staged = check_rglru_scan_bwd(RG_TRAIN_SCAN, device, card, time_it=True)
    bwd = [staged,
           check_rglru_scan_bwd(RG_TRAIN_SCAN, device, card, time_it=True,
                                misaligned=True, plain_of=staged),
           *(check_rglru_scan_bwd(shape, device, card, False, off)
             for shape in ((4, 2040, 4096), (3, 129, 100), (1, 1, 36),
                           (2, 77, 36))
             for off in (False, True)),
           check_rglru_scan_bwd((2, 1000, 130), device, card, False),
           check_rglru_scan_bwd((1, 77, 7), device, card, False)]
    lap("rglru_scan_bwd")
    out = {
        "rglru_scan": scan,
        "rglru_scan_bwd": bwd,
        "flash_decode": [
            check_flash_decode(4, 16, 1, 256, 2048, full_len, None,
                               "bfloat16", device, card, time_it=True),
            check_flash_decode(4, 16, 1, 256, 2048, [2048, 2041, 1000, 1],
                               None, "bfloat16", device, card, False),
            check_flash_decode(4, 16, 1, 256, 2048, full_len, None,
                               "float32", device, card, False),
            check_flash_decode(4, 16, 1, 256, 2048, [2048, 2041, 1000, 1],
                               None, "float32", device, card, False),
            check_flash_decode(2, 7, 1, 32, 1000, [1000, 611], 300,
                               "bfloat16", device, card, False),
            check_flash_decode(2, 7, 1, 40, 1000, [999, 0], None,
                               "bfloat16", device, card, False),
            check_flash_decode(2, 7, 1, 32, 1000, [999, 130], None,
                               "float32", device, card, False),
            check_flash_decode(3, 8, 2, 64, 1000, [1000, 513, 77], 128,
                               "float32", device, card, False),
            check_flash_decode(2, 16, 1, 56, 1000, [1000, 77], None,
                               "bfloat16", device, card, False),
            check_flash_decode(2, 8, 2, 48, 1000, [1000, 129], 300,
                               "bfloat16", device, card, False),
            check_flash_decode(2, 4, 1, 24, 1000, [999, 65], None,
                               "bfloat16", device, card, False),
            *gemma3_flash_checks(device, card),
            *qwen3_flash_checks(device, card),
            *frontend_flash_checks(device, card),
            *kimi_flash_checks(device, card)],
    }
    lap("flash_decode")
    log(f"lm kernels phase seconds by part: {seconds}")
    return out


#: gemma3-12b's attention at the serve shape: H 16 over K 8 (G = 2),
#: hd 240 (the bf16 score loop ends on a 16-dimension step), a global
#: layer's 2056 keys and a local layer's full ring of 1024
GEMMA3_FLASH = dict(b=4, h=16, kv=8, hd=240, s=2056, ring=1024)


def gemma3_flash_checks(device, card: str) -> list:
    """Flash decode at gemma3-12b's shapes in bf16 and fp32: the global
    layer (timed cold and warm beside SDPA and its bound, in bf16), the
    full ring, and lengths below S; each row marked ``gemma3``."""
    g = GEMMA3_FLASH
    b, h, kv, hd, s, ring = (g[k] for k in ("b", "h", "kv", "hd", "s",
                                            "ring"))
    rows = []
    for dtype in ("bfloat16", "float32"):
        for size, lengths in ((s, [s] * b), (ring, [ring] * b),
                              (s, [s, s - 56, ring + 1, 1])):
            timed = dtype == "bfloat16" and size == s and lengths[1] == s
            rows.append(check_flash_decode(b, h, kv, hd, size, lengths, None,
                                           dtype, device, card, timed)
                        | {"gemma3": True})
    return rows


#: qwen3-moe-30b-a3b's attention at the serve shape: H 32 over K 4 (G = 8),
#: hd 64, 2056 keys
QWEN3_FLASH = dict(b=4, h=32, kv=4, hd=64, s=2056)


def qwen3_flash_checks(device, card: str) -> list:
    """Flash decode at qwen3-moe-30b-a3b's decode shape in bf16 (timed
    cold and warm beside SDPA and its bound) and fp32, and with lengths
    below S; each row marked ``qwen3``."""
    g = QWEN3_FLASH
    b, h, kv, hd, s = (g[k] for k in ("b", "h", "kv", "hd", "s"))
    rows = []
    for dtype in ("bfloat16", "float32"):
        for lengths in ([s] * b, [s, s - 56, 1025, 1]):
            timed = dtype == "bfloat16" and lengths[1] == s
            rows.append(check_flash_decode(b, h, kv, hd, s, lengths, None,
                                           dtype, device, card, timed)
                        | {"qwen3": True})
    return rows


#: flash decode on the frontends' serve paths (batch 4), each key a row
#: mark: whisper-large-v3's decoder self-attention (H = K = 20, G = 1,
#: hd 64) over its 2056-slot cache, timed at the last step's 16 valid
#: keys; its cached cross-attention over the 1500 encoder frames, every
#: key valid; qwen2-vl-2b's self-attention (H 12 over K 2, G = 6, hd 128)
#: over 256 patches, the 2040-token prompt and 16 generated tokens
FRONTEND_FLASH = {
    "whisper_self": dict(h=20, kv=20, hd=64, s=2056, timed=[16] * 4,
                         ragged=[2056, 2041, 16, 1]),
    "whisper_cross": dict(h=20, kv=20, hd=64, s=1500, timed=[1500] * 4,
                          ragged=[1500, 1499, 751, 1]),
    "qwen2vl": dict(h=12, kv=2, hd=128, s=2312, timed=[2312] * 4,
                    ragged=[2312, 2297, 1025, 1])}


def frontend_flash_checks(device, card: str) -> list:
    """Flash decode at the three ``FRONTEND_FLASH`` shapes in bf16 (the
    serve path's lengths timed cold and warm beside SDPA and the bound)
    and fp32, and with ragged lengths; each row marked with its key."""
    rows = []
    for key, g in FRONTEND_FLASH.items():
        for dtype in ("bfloat16", "float32"):
            for lengths in (g["timed"], g["ragged"]):
                timed = dtype == "bfloat16" and lengths is g["timed"]
                rows.append(check_flash_decode(
                    4, g["h"], g["kv"], g["hd"], g["s"], lengths, None,
                    dtype, device, card, timed) | {key: True})
    return rows


#: RecurrentGemma-9B's serve runs one 19-layer pattern of its two (13
#: RG-LRU, 6 local layers): the depth cut that pays for the model zoo's
#: phases; each layer kind keeps its full width, and the scan its
#: full-shape timed row in the LM kernel phase
RG_SERVE_LAYERS = 19


def phase_serve(device) -> dict:
    """RecurrentGemma-9B at full width and one pattern's depth, bf16,
    seeded random weights: prefill 4 × 2040 tokens and 15 greedy decode
    steps through ``launch/serve.py``, the local rings wrapping at decode
    step 8; then the decode logits against a teacher-forced ``apply``, a
    profile, and the generation and check again with the same weights in
    fp32."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.registry import build_model, random_batch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(dataclasses.replace(get_config(LM_ARCH),
                                            n_layers=RG_SERVE_LAYERS),
                        device=device).init(SERVE["seed"])
    torch.cuda.synchronize()
    cfg = model.cfg
    init_s = note_init(f"{LM_ARCH} {cfg.n_layers} layers",
                       time.perf_counter() - t0)
    n_params = sum(p.numel() for p in model.parameters())
    kinds = [blk.kind for blk in model.layers]
    log(f"serve: {LM_ARCH} {cfg.n_layers} layers ({kinds.count('rglru')} "
        f"rglru, {kinds.count('local')} local), d {cfg.d_model}, vocab "
        f"{cfg.vocab}, {n_params:,} params ({cfg.param_count():,} by "
        f"param_count), {cfg.dtype}, init {init_s:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    bsz, prompt, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    max_len = prompt + gen
    batch = random_batch(cfg, bsz, prompt, seed=SERVE["seed"], device=device)
    # Warm-up (cuBLAS handles and plans, the allocator), uncounted.
    for _ in serve.generate(model, {"tokens": batch["tokens"][:, :64]}, 2,
                            66):
        pass

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    steps = serve.generate(model, batch, gen, max_len)
    first = next(steps)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = launch_counts()
    rest = list(steps)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    counts = launch_counts()
    by_path = path_counts()
    peak = torch.cuda.max_memory_allocated()
    n_rglru, n_local = kinds.count("rglru"), kinds.count("local")
    want_prefill = {n: 0 for n in _wrappers()} | {"rglru_scan": n_rglru}
    want_total = want_prefill | {"flash_decode": n_local * (gen - 1)}
    # Every scan on the staged path (D % 4 == 0).
    want_paths = {"rglru_scan": {"staged": n_rglru, "loop": 0},
                  "rglru_scan_bwd": {"staged": 0, "loop": 0}}
    log(f"serve: prefill {bsz}x{prompt} in {t_prefill * 1e3:.1f} ms, "
        f"{gen - 1} decode steps in {(t_total - t_prefill) * 1e3:.1f} ms "
        f"({(t_total - t_prefill) / (gen - 1) * 1e3:.2f} ms per step), "
        f"{bsz * gen / t_total:.1f} tok/s over the whole call, peak "
        f"allocated {peak / 2**30:.2f} GiB, launches after prefill "
        f"{after_prefill}, after decode {counts}, by path {by_path}")
    if (after_prefill != want_prefill or counts != want_total
            or by_path != want_paths):
        raise AssertionError(f"serve launches: after prefill {after_prefill} "
                             f"(want {want_prefill}), after decode {counts} "
                             f"(want {want_total}), by path {by_path} (want "
                             f"{want_paths})")
    ids = torch.cat([first[0]] + [tok for tok, _ in rest], dim=1)
    logits = torch.stack([first[1]] + [lg for _, lg in rest], dim=1)
    if tuple(ids.shape) != (bsz, gen) or not bool(logits.isfinite().all()):
        raise AssertionError(f"serve: ids {tuple(ids.shape)}, finite logits "
                             f"{bool(logits.isfinite().all())}")

    teacher = teacher_forced_errors(model, batch["tokens"], ids, logits)
    del logits
    row = {"prefill_ms": t_prefill * 1e3,
           "decode_ms_per_step": (t_total - t_prefill) / (gen - 1) * 1e3,
           "tok_per_s": bsz * gen / t_total, "peak_gib": peak / 2**30,
           "launches": {"rglru_scan": counts["rglru_scan"],
                        "flash_decode": counts["flash_decode"]},
           "launches_by_path": by_path,
           "ids_row0": ids[0].tolist(),
           "teacher": {cfg.dtype: teacher}}
    log(f"serve: ids row 0 {row['ids_row0']}")
    hold_teacher(teacher, cfg.dtype, prompt + gen)

    # Where a step's time goes: one profiled prefill, then three profiled
    # decode steps after a warm one (uncounted: launch counts are read
    # above).
    prefill = make_prefill_step(model, max_len)
    step = make_serve_step(model)
    tok, _, cache = prefill(batch)
    tok, _, cache = step(cache, tok)
    for label, fn, reps in (
            ("prefill", lambda: prefill(batch), 1),
            ("decode step", lambda: step(cache, tok), 3)):
        row[label.replace(" ", "_") + "_profile"] = profile_breakdown(
            fn, reps, label)

    # The same path in fp32 with the same weights: decode and the
    # teacher-forced apply agree to float rounding there, so this pass
    # holds the ring's slots and lengths at full width.
    del prefill, step, tok, cache, fn
    model = as_float32(model)
    torch.cuda.empty_cache()
    ids, logits = greedy(model, batch, gen, max_len)
    row["teacher"]["float32"] = teacher = teacher_forced_errors(
        model, batch["tokens"], ids, logits)
    hold_teacher(teacher, "float32", prompt + gen)
    return row


def as_float32(model, n_layers: int | None = None):
    """An fp32 model holding ``model``'s weights (its first ``n_layers``
    layers, of the encoder too for an encoder-decoder, when given)."""
    import dataclasses

    import torch

    from repro_torch.models.registry import build_model

    cfg = model.cfg
    n_layers = min(n_layers or cfg.n_layers, cfg.n_layers)
    cut = dict(n_layers=n_layers)
    if cfg.encoder_layers:
        cut["encoder_layers"] = min(n_layers, cfg.encoder_layers)
    out = build_model(dataclasses.replace(cfg, dtype="float32", **cut),
                      device=model.device)
    stacks = ("layers", "enc_layers", "dec_layers")
    state = {k: v for k, v in model.state_dict().items()
             if k.split(".")[0] not in stacks
             or int(k.split(".")[1]) < n_layers}
    out.load_state_dict(state)
    return out


def greedy(model, batch, gen: int, max_len: int):
    """``launch/serve.py``'s ``generate``: ids (B, gen) and their logits
    (B, gen, vocab)."""
    import torch

    from repro_torch.launch import serve

    ids, logits = zip(*serve.generate(model, batch, gen, max_len))
    return torch.cat(ids, 1), torch.stack(logits, 1)


def teacher_forced_errors(model, prompt, ids, logits) -> dict:
    """Decode logits (B, gen, vocab) of the ids (B, gen) that followed
    ``prompt`` (B, T) against one teacher-forced ``apply`` over
    prompt + ids: the relative RMS error at each position, the largest
    absolute error, the logits' RMS and the share of equal argmaxes.
    ``prompt`` may be a batch dict, whose stub inputs (a vision stub's
    patches) then go ahead of the text."""
    import torch

    batch = prompt if isinstance(prompt, dict) else {"tokens": prompt}
    t, gen = batch["tokens"].shape[1], ids.shape[1]
    tokens = torch.cat([batch["tokens"], ids], 1)
    with torch.no_grad():
        full = model.apply(dict(batch, tokens=tokens))
    off = full.shape[1] - tokens.shape[1]
    forced = full[:, off + t - 1:off + t - 1 + gen].clone()
    del full
    return logit_errors(logits, forced)


def logit_errors(logits, forced) -> dict:
    """Logits (B, gen, vocab) against ``forced`` of the same shape: the
    relative RMS error at each position, the largest absolute error, the
    logits' RMS and the share of equal argmaxes."""
    gen = logits.shape[1]
    per_pos = [_rel_rms(logits[:, j], forced[:, j]) for j in range(gen)]
    return {"rel_rms": per_pos, "rel_rms_max": max(per_pos),
            "max_abs": float((logits - forced).abs().max()),
            "logit_rms": float(forced.pow(2).mean().sqrt()),
            "argmax_agree": float((logits.argmax(-1) == forced.argmax(-1))
                                  .float().mean())}


def hold_teacher(teacher: dict, dtype: str, tokens: int,
                 bound: float | None = None,
                 what: str = "decode vs teacher-forced apply") -> None:
    """The teacher check at ``bound``, ``TEACHER_REL_RMS[dtype]`` unless
    an arch states its own; ``what`` names the two logits compared."""
    bound = TEACHER_REL_RMS[dtype] if bound is None else bound
    log(f"serve {dtype}: {what} over {tokens} "
        f"positions: relative RMS error per position "
        f"{' '.join(f'{e:.2e}' for e in teacher['rel_rms'])} (bound "
        f"{bound}), max abs {teacher['max_abs']:.4g} on logits of RMS "
        f"{teacher['logit_rms']:.3f}, argmax agreement "
        f"{teacher['argmax_agree']:.3f}")
    if not teacher["rel_rms_max"] <= bound:
        raise AssertionError(f"{dtype} {what}: beyond {bound}: "
                             f"{teacher['rel_rms']}")


def profile_breakdown(fn, reps: int, label: str) -> dict:
    """``fn`` run ``reps`` times under ``torch.profiler``: device time by
    kernel class, the union of kernel intervals (busy) and the profiled
    wall time, per rep. Reads the trace's raw device events: building
    the profiler's event tree (``key_averages``) costs ~0.1 ms an event,
    a minute for an xLSTM prefill's ~190 k kernels."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    spans, per_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.duration_ns() <= 0:
            continue
        spans.append((e.start_ns(), e.end_ns()))
        ms, count = per_name.get(e.name(), (0.0, 0))
        per_name[e.name()] = (ms + e.duration_ns() / 1e6 / reps, count + 1)
    by_class: dict[str, float] = {}
    for key, (ms, _) in per_name.items():
        name = key.lower()
        cls = ("flash_decode" if "flash_decode" in name else
               "rglru_scan" if "rglru_scan" in name else
               "matmul" if any(w in name for w in ("gemm", "gemv", "sm90",
                                                    "cutlass", "xmma",
                                                    "nvjet"))
               else "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms
    busy = union_ms(spans) / 1e6 / reps
    top = sorted(((ms, key) for key, (ms, _) in per_name.items()),
                 reverse=True)[:6]
    out = {"wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
           "kernel_ms": sum(by_class.values()), "by_class_ms": by_class,
           "launches": len(spans) / reps}
    log(f"profile {label}: {wall:.2f} ms wall (profiled), device busy "
        f"{busy:.2f} ms (share {busy / wall:.3f}), {out['launches']:.0f} "
        f"kernel launches, kernel ms by class "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_class.items()))
        + "; top: " + "; ".join(f"{k[:60]} {v:.3f}" for v, k in top))
    return out


# ---------------------------------------------------------------------------
# The attention-only model zoo (gemma3-12b at full width and depth, three
# more archs at full width and 2 layers) and RWSADMM training of
# tinyllama-1.1b.
ZOO_ARCH = "gemma3-12b"
#: gemma3-12b's fp32 pass: its first pattern (5 local layers, 1 global)
ZOO_FP32_LAYERS = 6
#: archs held at full width with their depth cut to 2 layers
ZOO_CUTS = ("tinyllama-1.1b", "qwen2-7b", "yi-34b")
ZOO_CUT_LAYERS = 2
#: the qkv bias (zeros at init, as the reference's) drawn at this scale
#: for the serve check, so that the card adds something
QKV_BIAS_SCALE = 0.5


def serve_lm(model, label: str, teacher_bound: float | None = None, *,
             rows: int | None = None, teacher: bool = True) -> dict:
    """``launch/serve.py``'s generation of ``SERVE``'s batch (its first
    ``rows`` rows when given) on ``model``: exactly one ``flash_decode``
    launch per attention layer and decode step and no other kernel (none
    at all without attention); unless ``teacher`` is false, the decode
    logits against a teacher-forced ``apply`` at the dtype's bound (or
    ``teacher_bound``); prefill and decode times, tokens/s and peak
    memory."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models.registry import random_batch

    cfg = model.cfg
    bsz, prompt, gen = rows or SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    max_len = serve.max_len_for(cfg, prompt, gen)
    batch = random_batch(cfg, SERVE["batch"], prompt, seed=SERVE["seed"],
                         device=model.device)
    batch = {k: v[:bsz] for k, v in batch.items()}    # tokens and stubs
    for _ in serve.generate(model, dict(batch, tokens=batch["tokens"][:, :64]),
                            2, serve.max_len_for(cfg, 64, 2)):
        pass    # warm-up, uncounted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    steps = serve.generate(model, batch, gen, max_len)
    first = next(steps)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = launch_counts()
    rest = list(steps)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_attn = sum(blk.kind in ("attn", "local") for blk in model.layers)
    want_prefill = {n: 0 for n in _wrappers()}
    want_total = want_prefill | {"flash_decode": n_attn * (gen - 1)}
    ids = torch.cat([first[0]] + [tok for tok, _ in rest], dim=1)
    logits = torch.stack([first[1]] + [lg for _, lg in rest], dim=1)
    row = {"layers": cfg.n_layers, "dtype": cfg.dtype,
           "prefill_ms": t_prefill * 1e3,
           "decode_ms_per_step": (t_total - t_prefill) / (gen - 1) * 1e3,
           "tok_per_s": bsz * gen / t_total, "peak_gib": peak / 2**30,
           "launches": {"flash_decode": counts["flash_decode"]},
           "ids_row0": ids[0].tolist()}
    log(f"{label}: {cfg.n_layers} layers {cfg.dtype}: prefill {bsz}x{prompt} "
        f"(after {max_len - prompt - gen} stub patches) "
        f"in {row['prefill_ms']:.1f} ms, {gen - 1} decode steps at "
        f"{row['decode_ms_per_step']:.2f} ms a step, {row['tok_per_s']:.1f} "
        f"tok/s over the call, peak allocated {row['peak_gib']:.2f} GiB, "
        f"launches {counts}; ids row 0 {row['ids_row0']}")
    if (after_prefill != want_prefill or counts != want_total
            or tuple(ids.shape) != (bsz, gen)
            or not bool(logits.isfinite().all())):
        raise AssertionError(f"{label}: launches after prefill "
                             f"{after_prefill} (want {want_prefill}), after "
                             f"decode {counts} (want {want_total}), ids "
                             f"{tuple(ids.shape)}, finite logits "
                             f"{bool(logits.isfinite().all())}")
    if teacher:
        row["teacher"] = teacher_forced_errors(model, batch, ids, logits)
        del logits
        hold_teacher(row["teacher"], cfg.dtype, max_len, teacher_bound)
    return row


def profile_serve(model, label: str) -> dict:
    """One profiled prefill of ``SERVE``'s batch (with its stub patches)
    and three decode steps after it (``profile_breakdown``)."""
    from repro_torch.launch.serve import max_len_for
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.registry import random_batch

    bsz, prompt, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    batch = random_batch(model.cfg, bsz, prompt, seed=SERVE["seed"],
                         device=model.device)
    prefill = make_prefill_step(model, max_len_for(model.cfg, prompt, gen))
    step = make_serve_step(model)
    tok, _, cache = prefill(batch)
    tok, _, cache = step(cache, tok)
    return {"prefill_profile": profile_breakdown(
                lambda: prefill(batch), 1, f"{label} prefill"),
            "decode_step_profile": profile_breakdown(
                lambda: step(cache, tok), 3, f"{label} decode step")}


def phase_zoo_serve(device) -> dict:
    """gemma3-12b at full width and depth (48 layers: 40 local with a
    1024-key ring that wraps during the 2040-token prefill, 8 global), bf16,
    seeded random weights, through ``launch/serve.py``: 720 flash-decode
    launches and nothing else, the teacher check, a profiled prefill and
    decode step; its first pattern again in fp32 with the same weights;
    then tinyllama-1.1b, qwen2-7b (qkv bias, G = 7) and yi-34b (G = 7) at
    full width and 2 layers through the same serve and check."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.registry import build_model

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = serve.load_model(ZOO_ARCH, device=device, seed=SERVE["seed"])
    torch.cuda.synchronize()
    cfg = model.cfg
    kinds = [blk.kind for blk in model.layers]
    n_params = sum(p.numel() for p in model.parameters())
    out = {ZOO_ARCH: {"params": n_params, "param_count": cfg.param_count(),
                      "init_s": note_init(ZOO_ARCH,
                                          time.perf_counter() - t0)}}
    log(f"zoo: {ZOO_ARCH} {cfg.n_layers} layers ({kinds.count('local')} "
        f"local, window {cfg.window}, {kinds.count('attn')} global), d "
        f"{cfg.d_model}, hd {cfg.hd}, H {cfg.n_heads} over K "
        f"{cfg.n_kv_heads}, vocab {cfg.vocab}, {n_params:,} params "
        f"({cfg.param_count():,} by param_count), {cfg.dtype}, init "
        f"{out[ZOO_ARCH]['init_s']:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    out[ZOO_ARCH] |= serve_lm(model, ZOO_ARCH)
    out[ZOO_ARCH] |= profile_serve(model, ZOO_ARCH)
    model = as_float32(model, ZOO_FP32_LAYERS)
    torch.cuda.empty_cache()
    out[ZOO_ARCH]["float32"] = serve_lm(model, f"{ZOO_ARCH} fp32")
    del model
    torch.cuda.empty_cache()

    for arch in ZOO_CUTS:
        cfg = dataclasses.replace(get_config(arch), n_layers=ZOO_CUT_LAYERS)
        t0 = time.perf_counter()
        model = build_model(cfg, device=device).init(SERVE["seed"])
        if cfg.qkv_bias:
            gen_b = torch.Generator().manual_seed(SERVE["seed"])
            with torch.no_grad():
                for blk in model.layers:
                    for b in (blk.mix.bq, blk.mix.bk, blk.mix.bv):
                        b.copy_(torch.randn(b.shape, generator=gen_b)
                                * QKV_BIAS_SCALE)
        torch.cuda.synchronize()
        init_s = note_init(f"{arch} {cfg.n_layers} layers",
                           time.perf_counter() - t0)
        log(f"zoo: {arch} cut to {cfg.n_layers} layers, d {cfg.d_model}, "
            f"hd {cfg.hd}, H {cfg.n_heads} over K {cfg.n_kv_heads}, vocab "
            f"{cfg.vocab}, qkv bias {cfg.qkv_bias}, tied "
            f"{cfg.tie_embeddings}, "
            f"{sum(p.numel() for p in model.parameters()):,} params, init "
            f"{init_s:.2f} s")
        out[arch] = serve_lm(model, arch)
        del model
        torch.cuda.empty_cache()
    return out


#: tinyllama-1.1b trained at full width and depth in its config's bf16:
#: three clients on the walker, 4 × 2048 tokens a step (its context),
#: five rounds, at the reference example's hyperparameters
TRAIN = dict(arch="tinyllama-1.1b", clients=3, batch=4, seq=2048, rounds=5,
             seed=0, beta=2.0, kappa=0.001, epsilon=1e-5)
#: one step of a fp32 cut (tinyllama-1.1b: 2 layers), card against CPU,
#: on 2 × 256 tokens: x, z and y at this tolerance except y's sign flips,
#: which must be ties (|y' − x| within twice the tolerance) and few
PARITY_STEP = dict(layers=2, batch=2, seq=256, atol=1e-6, rtol=1e-5,
                   max_flip_share=1e-4)


def promoted_dtypes(params: dict, step: int) -> dict:
    """The leaves' dtypes (x, z, y) after ``step`` 1 or 2 under the
    reference's promotion (its κ is a strong fp32 scalar): x keeps each
    leaf's own dtype (bf16, or fp32 for the xLSTM's ``w_if`` and
    ``b_gates``) for one step and is fp32 after the second; z and y are
    fp32 from the first."""
    import torch

    return {n: {k: v.dtype if (n, step) == ("x", 1) else torch.float32
                for k, v in params.items()} for n in ("x", "z", "y")}


def stub_inputs(cfg, batch: int, seed: int, device) -> dict:
    """A stub frontend's inputs (``frames`` or ``patches``) of ``batch``
    rows, as ``random_batch`` draws them after its tokens; none for a
    plain LM."""
    from repro_torch.models.registry import random_batch

    out = random_batch(cfg, batch, 1, seed=seed, device=device)
    del out["tokens"]
    return out


def lm_step_parity(device, arch: str, layers: int, grad_share: float = 0.0,
                   deep_tie: float = 0.0, check=None,
                   cut: dict | None = None,
                   shape: tuple[int, int] | None = None) -> dict:
    """One RWSADMM step of ``arch`` at full width, cut to its first
    ``layers`` layers, fp32, from the same weights and tokens on the card
    and on the CPU: x, z and y at ``PARITY_STEP``'s tolerance, its atol
    raised by ``grad_share`` of each leaf's step (its largest |new − old|
    on the CPU); y's sign flips must be ties, and those at ties deeper than
    ``deep_tie`` of the tie are not counted against ``max_flip_share``.
    ``check(cpu, card, tokens)``, when given, runs before the step and its
    result is kept under "check". ``cut`` replaces more config fields
    (an encoder's layers and frames, a layer pattern); a stub frontend's
    inputs come from ``stub_inputs``. ``shape``: the step's (batch, seq)
    tokens, ``PARITY_STEP``'s unless given."""
    import dataclasses

    import numpy as np
    import torch

    from examples.federated_lm_torch import heterogeneous_stream
    from repro_torch.configs import get_config
    from repro_torch.core.rwsadmm import RWSADMMHparams
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models.registry import build_model

    p = PARITY_STEP
    bsz, seq = shape or (p["batch"], p["seq"])
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              dtype="float32", **(cut or {}))
    hp = RWSADMMHparams(beta=TRAIN["beta"], kappa=TRAIN["kappa"],
                        epsilon=TRAIN["epsilon"])
    # drawn on the card (on the host's plain threefry a billion fp32
    # leaves take minutes), then copied: both sides hold the same bits
    t0 = time.perf_counter()
    card = build_model(cfg, device=device).init(TRAIN["seed"])
    torch.cuda.synchronize()
    note_init(f"{arch} fp32 {layers} layers (card-vs-CPU step)",
              time.perf_counter() - t0)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    tokens = heterogeneous_stream(cfg.vocab, 1, bsz, seq,
                                  np.random.default_rng(TRAIN["seed"]))
    stubs = stub_inputs(cfg, bsz, TRAIN["seed"], "cpu")
    checked = check(cpu, card, tokens) if check is not None else None
    results = []
    for model in (cpu, card):
        params = {k: v.detach() for k, v in model.named_parameters()}
        batch = {"tokens": torch.as_tensor(tokens, device=model.device)}
        batch |= {k: v.to(model.device) for k, v in stubs.items()}
        t0 = time.perf_counter()
        state, loss = make_train_step(model, hp, TRAIN["clients"])(
            init_train_state(params, hp), batch)
        results.append((state, float(loss), time.perf_counter() - t0))
    (want, want_loss, cpu_s), (got, got_loss, card_s) = results
    # compared on the card: the same elementwise tests, which take
    # minutes on the host at a billion parameters
    want = want._replace(**{n: {k: v.to(device) for k, v in
                                getattr(want, n).items()}
                            for n in ("x", "z", "y")})
    start = {k: v.detach().to(device)                            # y' = x'
             for k, v in cpu.named_parameters()}
    old = {"x": start, "y": start,
           "z": {k: torch.zeros_like(v) for k, v in start.items()}}
    atol = {n: {leaf: p["atol"] + grad_share * float(
        (w - old[n][leaf]).abs().max()) for leaf, w in getattr(want, n).items()}
        for n in ("x", "z", "y")}
    errs, flips, counted, beyond_plain = {}, 0, 0, 0
    for name in ("x", "z", "y"):
        worst = 0.0
        for leaf, w in getattr(want, name).items():
            g = getattr(got, name)[leaf]
            bad = ~torch.isclose(g, w, atol=atol[name][leaf], rtol=p["rtol"])
            plain = ~torch.isclose(g, w, atol=p["atol"], rtol=p["rtol"])
            if name == "y":     # sgn(y' − x) may differ at a tie
                y0 = start[leaf]
                gap = (y0 - want.x[leaf]).abs() / (
                    2 * (atol["x"][leaf] + p["rtol"] * y0.abs()))
                flip = torch.sign(y0 - want.x[leaf]) != torch.sign(
                    y0 - got.x[leaf])
                deep = int((flip & (gap < deep_tie)).sum())
                if bool((flip & (gap > 1)).any()) or \
                        int(flip.sum()) - deep > \
                        p["max_flip_share"] * flip.numel() + 1:
                    raise AssertionError(f"lm step parity: {leaf} flips "
                                         f"{int(flip.sum())}, not ties")
                flips += int(flip.sum())
                counted += int(flip.sum()) - deep
                bad &= ~flip
                plain &= ~flip
            if bool(bad.any()):
                raise AssertionError(
                    f"lm step parity: {name} {leaf} card vs CPU beyond "
                    f"{atol[name][leaf]:.3g}/{p['rtol']}: "
                    f"{float((g - w).abs().max())}")
            beyond_plain += int(plain.sum())
            worst = max(worst, float((g - w).abs().max()))
        errs[name] = worst
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    row = {"loss_cpu": want_loss, "loss_card": got_loss, "loss_rel": loss_rel,
           "max_abs": errs, "y_sign_flips": flips,
           "y_sign_flips_counted": counted,
           "beyond_plain_tolerance": beyond_plain,
           "step_s": {"cpu": cpu_s, "card": card_s},
           "tokens": bsz * seq, "check": checked,
           "cut": dict(cut or {}, n_layers=layers)}
    log(f"train parity: {arch} {layers} layers fp32 (cut {row['cut']}), one "
        f"step on {bsz}x{seq} tokens and "
        f"{ {k: tuple(v.shape) for k, v in stubs.items()} } stub inputs "
        f"(CPU {cpu_s:.1f} s, card "
        f"{card_s:.2f} s), card vs CPU: loss {got_loss} vs {want_loss} (rel "
        f"{loss_rel:.3g}), max abs x/z/y {errs}, y sign flips at ties "
        f"{flips} ({counted} above {deep_tie} of a tie) (tolerance atol "
        f"{p['atol']} + {grad_share} of the leaf's step, rtol {p['rtol']}; "
        f"elements beyond atol {p['atol']} alone: {beyond_plain})")
    if not loss_rel <= p["rtol"]:
        raise AssertionError(f"lm step parity: loss {row}")
    return row


def train_on_walker(device, t: dict, label: str) -> dict:
    """RWSADMM training of ``t["arch"]`` at full width and depth (cut to
    ``t["layers"]`` layers, or by ``t["cut"]``'s config fields, a
    ``layer_pattern`` among them, when given) through
    ``launch/steps.py``'s ``make_train_step``: a random walk over
    ``t["clients"]`` clients' heterogeneous streams (with a stub
    frontend's frames or patches drawn for each client) for
    ``t["rounds"]`` rounds; gated on finite losses, x moved, κ decayed,
    the reference's dtype promotion after steps 1 and 2, and each hand
    kernel's launches: exactly ``t["launches"]`` a step (none of any
    kernel unless given)."""
    import dataclasses

    import numpy as np
    import torch

    from examples.federated_lm_torch import heterogeneous_stream
    from repro_torch.configs import get_config
    from repro_torch.core.graph import DynamicGraph
    from repro_torch.core.markov import RandomWalkServer
    from repro_torch.core.rwsadmm import RWSADMMHparams
    from repro_torch.launch.steps import TrainState, init_train_state, \
        make_train_step
    from repro_torch.models.registry import build_model

    t0 = time.perf_counter()
    cut = dict(t.get("cut", {}))
    if "layers" in t:
        cut["n_layers"] = t["layers"]
    cfg = dataclasses.replace(get_config(t["arch"]), **cut)
    model = build_model(cfg, device=device).init(t["seed"])
    torch.cuda.synchronize()
    init_s = note_init(f"{label}: {t['arch']} {cfg.n_layers} layers",
                       time.perf_counter() - t0)
    params = {k: v.detach() for k, v in model.named_parameters()}
    log(f"{label}: {t['arch']} {cfg.n_layers} layers, d {cfg.d_model}, vocab "
        f"{cfg.vocab}, {sum(v.numel() for v in params.values()):,} params "
        f"{cfg.dtype}, init {init_s:.2f} s")
    hp = RWSADMMHparams(beta=t["beta"], kappa=t["kappa"],
                        epsilon=t["epsilon"])
    step = make_train_step(model, hp, n_total=t["clients"])
    rng = np.random.default_rng(t["seed"])
    batches = [{"tokens": torch.as_tensor(heterogeneous_stream(
        cfg.vocab, c, t["batch"], t["seq"], rng), device=device),
        **stub_inputs(cfg, t["batch"], t["seed"] + c, device)}
        for c in range(t["clients"])]
    states = [init_train_state(params, hp) for _ in range(t["clients"])]
    dyn = DynamicGraph(t["clients"], min_degree=2, regen_every=10, seed=0)
    walker = RandomWalkServer(seed=1)
    walker.reset(dyn.current())
    y, kappa = states[0].y, states[0].kappa
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    visits, losses, step_ms, dtypes, promoted = [], [], [], [], True
    for r in range(t["rounds"]):
        g = dyn.step() if r else dyn.current()
        i_k = walker.step(g) if r else walker.position
        st = TrainState(x=states[i_k].x, z=states[i_k].z, y=y, kappa=kappa)
        t1 = time.perf_counter()
        st, loss = step(st, batches[i_k])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        states[i_k], y, kappa = st, st.y, st.kappa
        visits.append(i_k)
        losses.append(float(loss))
        dtypes.append(tuple(str({v.dtype for v in getattr(st, n).values()})
                            for n in ("x", "z", "y")))
        if r < 2:
            promoted &= {n: {k: v.dtype for k, v in getattr(st, n).items()}
                         for n in ("x", "z", "y")} == promoted_dtypes(
                             params, r + 1)
    counts = launch_counts()
    want_counts = {n: 0 for n in counts} | {
        n: per_step * t["rounds"]
        for n, per_step in t.get("launches", {}).items()}
    peak = torch.cuda.max_memory_allocated()
    moved = any(not torch.equal(states[c].x[k].float(), params[k].float())
                for c in set(visits) for k in params)
    want_kappa = np.float32(t["kappa"])
    for _ in range(t["rounds"]):
        want_kappa = np.float32(want_kappa * np.float32(0.99))
    later = step_ms[2:] or step_ms[1:]    # the steps after the promotion
    steady = sorted(later)[len(later) // 2]
    tokens = t["batch"] * t["seq"]
    row = {"visits": visits, "losses": losses, "step_ms": step_ms,
           "steady_step_ms": steady, "tok_per_s": tokens / steady * 1e3,
           "peak_gib": peak / 2**30, "kappa": float(kappa),
           "dtypes_after_steps_1_2": dtypes[:2], "launches": counts,
           "launches_by_path": path_counts()}
    log(f"{label}: {t['rounds']} rounds over clients {visits}: losses "
        f"{losses}, ms a step {[round(m, 1) for m in step_ms]} (steady "
        f"median {steady:.1f} ms, {row['tok_per_s']:.0f} tokens/s on "
        f"{tokens} tokens a step), peak allocated {row['peak_gib']:.2f} GiB, "
        f"kappa {float(kappa)}, dtypes x/z/y after steps 1, 2 {dtypes[:2]}, "
        f"launches {counts}")
    if not (all(np.isfinite(losses)) and moved
            and abs(float(kappa) - float(want_kappa)) <= 1e-6 * want_kappa
            and promoted
            and counts == want_counts):
        raise AssertionError(f"{label}: finite {all(np.isfinite(losses))}, x "
                             f"moved {moved}, kappa {float(kappa)} (want "
                             f"{want_kappa}), dtypes {dtypes[:2]} (the "
                             f"reference's promotion {promoted}), launches "
                             f"{counts} (want {want_counts})")
    return row


def phase_train(device) -> dict:
    """RWSADMM training of tinyllama-1.1b at full width and depth
    (``train_on_walker`` at ``TRAIN``), then a 2-layer fp32 step card vs
    CPU and ``examples/federated_lm_torch.py`` at its default size."""
    import numpy as np
    import torch

    from examples.federated_lm_torch import main as federated_lm

    row = train_on_walker(device, TRAIN, "train")
    torch.cuda.empty_cache()
    row["parity"] = lm_step_parity(device, TRAIN["arch"],
                                   PARITY_STEP["layers"])
    zero_launch_counts()
    t0 = time.perf_counter()
    with counts_from_after_init():
        visits, ex_losses = federated_lm(["--device", str(device)])
        torch.cuda.synchronize()
    ex = {"seconds": time.perf_counter() - t0, "rounds": len(visits),
          "launches": launch_counts(),
          "first_last": {c: (v[0], v[-1]) for c, v in ex_losses.items()}}
    log(f"train: examples/federated_lm_torch.py at its default size: "
        f"{ex['rounds']} rounds in {ex['seconds']:.2f} s, first/last loss "
        f"per client {ex['first_last']}, launches {ex['launches']}")
    if not all(np.isfinite(v).all() for v in ex_losses.values()) \
            or any(ex["launches"].values()):
        raise AssertionError(f"federated_lm_torch: {ex}")
    row["example"] = ex
    return row


# ---------------------------------------------------------------------------
# The xLSTM family (mLSTM and sLSTM mixers): xlstm-350m served and trained
# at full width and depth. Plain torch ops only: no hand kernel (the JAX
# package has none for either block).
XLSTM_ARCH = "xlstm-350m"
#: the fp32 passes (serve, and the card-vs-CPU step): its first pattern,
#: 5 mLSTM layers and 1 sLSTM
XLSTM_FP32_LAYERS = 6
#: RWSADMM on xlstm-350m in its bf16: three clients on the walker, 4 × 512
#: tokens a step, two rounds (three until the smoke's time was cut, PERF.md
#: §4), at the reference example's hyperparameters
XLSTM_TRAIN = dict(TRAIN, arch=XLSTM_ARCH, seq=512, rounds=2)
#: the bf16 teacher check's bound for xlstm-350m (``TEACHER_REL_RMS``
#: stays as it is for every other arch). In bf16 the xLSTM's decode and
#: its teacher-forced ``apply`` part step by step: the reference itself,
#: at 24 layers (d 256, the CPU, a 2040-token prompt, 16 steps), reads
#: 3.6e-2 at the first decode step growing to 2.9e-1, and the port there
#: 5.6e-2 to 3.0e-1 (``tests/test_torch_xlstm_probe.py``); the H100 read
#: 5.8e-2 to 3.0e-1 at full width. Its signed mLSTM sums cancel: one ulp
#: on every weight moves the fp32 logits by 4e-5-8e-5 of their largest
#: at 6 layers and 5e-4-8e-4 at 24, so bf16's 2^-8 compounds over the
#: layers and the steps' states. 0.6 fails a fault of order one
#: (unrelated logits read ~1.4); the fp32 pass over the first pattern
#: holds the arithmetic at ``TEACHER_REL_RMS``'s 1e-4.
XLSTM_BF16_TEACHER = 0.6
#: the card-vs-CPU step's tolerance beyond ``PARITY_STEP``'s: in fp32 the
#: xLSTM's signed mLSTM sums cancel, so its gradients carry rounding of
#: ~1e-4 of each leaf's largest entry (6 layers, d 256: the packages'
#: part by 8.2e-5-1.2e-4, the port's own by 5.7e-5-8.9e-5 when its
#: weights move by one ulp; ``tests/test_torch_xlstm_probe.py``), and the
#: sLSTM's gate biases get gradients of ~1e-11 whose sign is noise
XLSTM_PARITY = dict(grad_share=3e-4, deep_tie=1e-3)


def xlstm_blocks(model) -> dict:
    """One mLSTM and one sLSTM layer of ``model`` alone over ``SERVE``'s
    prompt (4 × 2040 normal inputs in the model's dtype), each profiled:
    the sLSTM's loop over 2040 time steps against the mLSTM's chunked
    form."""
    import torch

    from repro_torch.models import recurrent as rec

    cfg = model.cfg
    gen = torch.Generator(device=model.device).manual_seed(SERVE["seed"])
    hn = torch.randn(SERVE["batch"], SERVE["prompt"], cfg.d_model,
                     generator=gen, device=model.device).to(model.embed.dtype)
    out = {}
    for kind, block in (("mlstm", rec.mlstm_block), ("slstm", rec.slstm_block)):
        mix = next(blk.mix for blk in model.layers if blk.kind == kind)
        with torch.no_grad():
            block(mix, hn, cfg)                              # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            block(mix, hn, cfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            out[kind] = profile_breakdown(
                lambda: block(mix, hn, cfg), 1,
                f"{XLSTM_ARCH} one {kind} layer over {SERVE['batch']}x"
                f"{SERVE['prompt']}") | {"ms": ms}
    out["slstm"]["launches_per_time_step"] = \
        out["slstm"]["launches"] / SERVE["prompt"]
    log(f"{XLSTM_ARCH} one layer over {SERVE['batch']}x{SERVE['prompt']}, "
        f"unprofiled: mLSTM {out['mlstm']['ms']:.1f} ms, sLSTM "
        f"{out['slstm']['ms']:.1f} ms ({out['slstm']['launches']:.0f} "
        f"launches, {out['slstm']['launches_per_time_step']:.1f} a time "
        f"step)")
    return out


def phase_xlstm(device) -> dict:
    """xlstm-350m at full width and depth (24 layers: 20 mLSTM, 4 sLSTM; d
    1024, 4 heads of mLSTM width 512, no FFN), bf16, seeded random
    weights, through ``launch/serve.py``: no hand kernel launched, the
    teacher check, a profiled prefill and decode step, one mLSTM and one
    sLSTM layer profiled alone; its first pattern in fp32 with the same
    weights at the fp32 bound; then RWSADMM training at full width and
    depth (``XLSTM_TRAIN``) and one step of the first pattern in fp32,
    card vs CPU."""
    import torch

    from repro_torch.launch import serve

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = serve.load_model(XLSTM_ARCH, device=device, seed=SERVE["seed"])
    torch.cuda.synchronize()
    cfg = model.cfg
    kinds = [blk.kind for blk in model.layers]
    n_params = sum(p.numel() for p in model.parameters())
    out = {"params": n_params, "param_count": cfg.param_count(),
           "init_s": note_init(XLSTM_ARCH, time.perf_counter() - t0)}
    log(f"xlstm: {XLSTM_ARCH} {cfg.n_layers} layers ({kinds.count('mlstm')} "
        f"mLSTM, {kinds.count('slstm')} sLSTM), d {cfg.d_model}, "
        f"{cfg.n_heads} heads of mLSTM width {2 * cfg.d_model // cfg.n_heads}"
        f", vocab {cfg.vocab}, {n_params:,} params ({cfg.param_count():,} "
        f"by param_count), {cfg.dtype}, init {out['init_s']:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    out |= serve_lm(model, XLSTM_ARCH, XLSTM_BF16_TEACHER)
    out |= profile_serve(model, XLSTM_ARCH)
    out["blocks"] = xlstm_blocks(model)
    model = as_float32(model, XLSTM_FP32_LAYERS)
    torch.cuda.empty_cache()
    out["float32"] = serve_lm(model, f"{XLSTM_ARCH} fp32")
    del model
    torch.cuda.empty_cache()
    out["train"] = train_on_walker(device, XLSTM_TRAIN, "xlstm train")
    torch.cuda.empty_cache()
    out["train"]["parity"] = lm_step_parity(device, XLSTM_ARCH,
                                            XLSTM_FP32_LAYERS, **XLSTM_PARITY)
    return out


# ---------------------------------------------------------------------------
# Mixture-of-Experts: qwen3-moe-30b-a3b served at full width and depth and
# trained at full width. Routing, dispatch and the expert GEMMs are plain
# torch ops (the JAX package has no kernel for them); its 48 attention
# layers decode through flash decode.
MOE_ARCH = "qwen3-moe-30b-a3b"
#: the no-drop passes: capacity factor E/k = 16 makes each expert's
#: capacity T, so the prefill, the decode steps and the teacher-forced
#: ``apply`` keep every slot and compute the same function (at the
#: published 1.25 the prefill drops slots that decode keeps); at batch 1,
#: SERVE's row 0, where a layer's dispatch buffers (128 × 2056 slots) take
#: ~3.1 GiB in bf16
MOE_NO_DROP = dict(capacity_factor=16.0, rows=1)
#: the bf16 no-drop teacher check's bound for qwen3-moe-30b-a3b
#: (``TEACHER_REL_RMS`` stays as it is for every other arch). Top-k
#: routing is discontinuous: bf16 rounding that parts decode from the
#: teacher-forced pass moves some tokens' 8th expert, and each such flip
#: moves the logits by far more than rounding does. The reference itself,
#: at 48 layers and capacity factor 16 (128 experts, top-8; d 256, the
#: CPU, batch 1, a 2040-token prompt, 16 steps), reads 1.2e-2-6.6e-2 a
#: position over seeds 0-2, the port there 1.0e-2-6.2e-2 with 13-19 % of
#: its (token, layer) top-8 sets differing between the two paths
#: (``tests/test_torch_moe_probe.py``); the H100 read 2.0e-2-6.3e-2 at
#: full width. Twice the reference's largest; the fp32 pass over the
#: first 2 layers holds the arithmetic at ``TEACHER_REL_RMS``'s 1e-4.
MOE_BF16_TEACHER = 0.13
#: the fp32 pass: the first 2 layers with the same weights
MOE_FP32_LAYERS = 2
#: RWSADMM on qwen3-moe-30b-a3b at full width cut to 1 layer
#: (1,236,017,152 parameters), in its bf16: two clients on the walker,
#: 4 × 512 tokens a step, two rounds; the card-vs-CPU step on that cut
MOE_TRAIN = dict(TRAIN, arch=MOE_ARCH, layers=1, clients=2, seq=512,
                 rounds=2)
#: the card-vs-CPU fp32 step's tokens (cut from PARITY_STEP's 2 × 256
#: to keep the smoke in its time)
MOE_PARITY_SHAPE = (1, 256)
#: a token whose top-8 set differs between the card and the CPU fails
#: the routing check when the CPU's gap between its 8th and 9th
#: probability exceeds this (below it, fp32 rounding may order them
#: either way)
MOE_FLIP_MARGIN = 1e-5


def with_capacity_factor(model, factor: float):
    """An ``LM`` holding ``model``'s weights (shared, not copied) whose
    MoE capacity factor is ``factor``."""
    import dataclasses

    from repro_torch.models.transformer import LM

    cfg = model.cfg
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))
    out = LM(cfg, device="meta")
    out.load_state_dict(model.state_dict(), assign=True)
    return out


def ffn_inputs(model, run) -> tuple[list, object]:
    """``run()`` with a forward hook on every layer's MoE ``ffn``: the
    inputs the layers got, each flattened to (T, d), in call order, and
    what ``run()`` returned."""
    seen = []
    hooks = [blk.ffn.register_forward_hook(
        lambda module, args, _: seen.append(
            args[0].detach().reshape(-1, args[0].shape[-1])))
        for blk in model.layers]
    try:
        return seen, run()
    finally:
        for h in hooks:
            h.remove()


def top_k_sets(ffn, xf):
    """Each token's top-k experts under the MoE layer ``ffn``'s router,
    sorted: (T, k)."""
    from repro_torch.models import moe

    return moe.route(ffn, xf, ffn.cfg)[1].sort(-1).values


def moe_prefill_drops(model) -> dict:
    """(token, expert) slots past their expert's capacity in each MoE layer
    during a prefill of ``SERVE``'s batch, from the layers' inputs
    (``ffn_inputs``)."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.registry import random_batch

    cfg = model.cfg
    batch = random_batch(cfg, SERVE["batch"], SERVE["prompt"],
                         seed=SERVE["seed"], device=model.device)
    with torch.no_grad():
        seen, _ = ffn_inputs(model, lambda: model.prefill(
            batch, SERVE["prompt"] + SERVE["gen"]))
        per_layer = [int(moe.dropped_slots(blk.ffn, xf, cfg))
                     for blk, xf in zip(model.layers, seen)]
    del seen
    t = SERVE["batch"] * SERVE["prompt"]
    slots = t * cfg.moe.top_k
    out = {"per_layer": per_layer, "slots_per_layer": slots,
           "capacity": moe.capacity(t, cfg),
           "share": sum(per_layer) / (slots * len(per_layer))}
    log(f"{cfg.arch_id} prefill {SERVE['batch']}x{SERVE['prompt']} at "
        f"capacity factor {cfg.moe.capacity_factor} (capacity "
        f"{out['capacity']} a expert, mean load {slots / cfg.moe.n_experts:.1f}"
        f"): dropped (token, expert) slots a layer {per_layer} of {slots} "
        f"(share {out['share']:.4f})")
    if len(per_layer) != cfg.n_layers:
        raise AssertionError(f"drops counted in {len(per_layer)} layers")
    return out


def moe_routing_flips(cpu, card, tokens) -> dict:
    """Layer 0's routing of ``tokens`` on the CPU and on the card: each
    token's top-k set, compared; a flip is printed with the CPU's gap
    between its k-th and (k+1)-th probability and fails above
    ``MOE_FLIP_MARGIN``."""
    import torch

    k = cpu.cfg.moe.top_k
    sets, xs = [], []
    with torch.no_grad():
        for model in (cpu, card):
            seen, _ = ffn_inputs(model, lambda: model.apply(
                {"tokens": torch.as_tensor(tokens, device=model.device)}))
            xs.append(seen[0])
            sets.append(top_k_sets(model.layers[0].ffn, seen[0]).cpu())
        probs = torch.softmax(xs[0].float() @ cpu.layers[0].ffn.router, -1)
    flipped = (sets[0] != sets[1]).any(-1).nonzero().flatten()
    ranked = probs.sort(-1, descending=True).values
    margins = (ranked[flipped, k - 1] - ranked[flipped, k]).tolist()
    row = {"tokens": int(sets[0].shape[0]), "flips": flipped.tolist(),
           "margins": margins}
    log(f"moe routing, layer 0, card vs CPU over {row['tokens']} tokens: "
        f"{len(margins)} top-{k} sets differ" + (
            f" (tokens {row['flips']}, margins {margins})" if margins else ""))
    if any(m > MOE_FLIP_MARGIN for m in margins):
        raise AssertionError(f"moe routing differs card vs CPU beyond a "
                             f"margin of {MOE_FLIP_MARGIN}: {row}")
    return row


def moe_teacher_route_flips(model, prompt, ids) -> dict:
    """Each layer's top-k sets at the decode positions: the decode steps
    (a prefill of ``prompt`` (B, T), then ``ids`` (B, gen) fed one at a
    time) against one teacher-forced ``apply`` over prompt + ids; counts
    the (token, layer) pairs whose sets differ."""
    import torch

    b, t = prompt.shape
    gen = ids.shape[1]
    flips = 0
    with torch.no_grad():
        seen, _ = ffn_inputs(model, lambda: model.apply(
            {"tokens": torch.cat([prompt, ids], 1)}))
        forced = [top_k_sets(blk.ffn, xf).reshape(b, t + gen, -1)
                  for blk, xf in zip(model.layers, seen)]
        del seen
        _, cache = model.prefill({"tokens": prompt}, t + gen)
        for j in range(gen - 1):
            seen, (_, cache) = ffn_inputs(model, lambda: model.decode_step(
                cache, ids[:, j:j + 1]))
            flips += sum(int((top_k_sets(blk.ffn, xf).reshape(b, -1)
                              != f[:, t + j]).any(-1).sum())
                         for blk, xf, f in zip(model.layers, seen, forced))
    row = {"flips": flips, "compared": b * (gen - 1) * len(model.layers)}
    log(f"{model.cfg.arch_id} decode vs teacher-forced apply: top-"
        f"{model.cfg.moe.top_k} sets differ in {flips} of "
        f"{row['compared']} (token, layer) pairs")
    return row


def phase_moe(device) -> dict:
    """qwen3-moe-30b-a3b at full width and depth (48 layers of attention, H
    32 over K 4, hd 64, and an MoE FFN of 128 experts, top-8, width 768),
    bf16, seeded random weights, through ``launch/serve.py`` at the
    published capacity factor 1.25: exactly 720 flash-decode launches and
    no other kernel, the prefill's dropped slots a layer, a profiled
    prefill and decode step; then, with the same weights at capacity
    factor 16, the bf16 teacher check on SERVE's row 0 and the first 2
    layers in fp32 at the fp32 bound; then RWSADMM training at full width
    cut to 1 layer (``MOE_TRAIN``) and one fp32 step of that cut, card vs
    CPU, after its layer-0 routing is compared."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models.registry import random_batch

    seconds, last = {}, [time.perf_counter()]

    def mark(label: str) -> None:   # the phase's seconds by part
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[label] = round(now - last[0], 1)
        last[0] = now

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = serve.load_model(MOE_ARCH, device=device, seed=SERVE["seed"])
    torch.cuda.synchronize()
    cfg, e = model.cfg, model.cfg.moe
    n_params = sum(p.numel() for p in model.parameters())
    out = {"params": n_params, "param_count": cfg.param_count(),
           "active_param_count": cfg.active_param_count(),
           "init_s": note_init(MOE_ARCH, time.perf_counter() - t0),
           "allocated_gib": torch.cuda.memory_allocated() / 2**30}
    log(f"moe: {MOE_ARCH} {cfg.n_layers} layers, d {cfg.d_model}, H "
        f"{cfg.n_heads} over K {cfg.n_kv_heads}, hd {cfg.hd}, {e.n_experts} "
        f"experts top-{e.top_k} width {e.d_expert} capacity factor "
        f"{e.capacity_factor}, vocab {cfg.vocab}, {n_params:,} params "
        f"({cfg.param_count():,} by param_count, "
        f"{cfg.active_param_count():,} active), {cfg.dtype}, init "
        f"{out['init_s']:.2f} s, {out['allocated_gib']:.2f} GiB")
    mark("init")
    out |= serve_lm(model, MOE_ARCH, teacher=False)
    mark("serve")
    out["dropped_slots"] = moe_prefill_drops(model)
    out |= profile_serve(model, MOE_ARCH)
    mark("drops and profile")
    factor, rows = MOE_NO_DROP["capacity_factor"], MOE_NO_DROP["rows"]
    model = with_capacity_factor(model, factor)
    out["no_drop"] = serve_lm(model, f"{MOE_ARCH} capacity factor {factor}",
                              MOE_BF16_TEACHER, rows=rows)
    prompt = random_batch(cfg, SERVE["batch"], SERVE["prompt"],
                          seed=SERVE["seed"], device=device)["tokens"][:rows]
    out["no_drop"]["route_flips"] = moe_teacher_route_flips(
        model, prompt, torch.tensor([out["no_drop"]["ids_row0"]],
                                    device=device))
    mark("no-drop teacher")
    model = as_float32(model, MOE_FP32_LAYERS)
    torch.cuda.empty_cache()
    out["float32"] = serve_lm(model, f"{MOE_ARCH} capacity factor {factor} "
                              f"fp32", rows=rows)
    del model
    torch.cuda.empty_cache()
    mark("fp32 teacher")
    out["train"] = train_on_walker(device, MOE_TRAIN, "moe train")
    torch.cuda.empty_cache()
    mark("train")
    out["train"]["parity"] = lm_step_parity(device, MOE_ARCH,
                                            MOE_TRAIN["layers"],
                                            check=moe_routing_flips,
                                            shape=MOE_PARITY_SHAPE)
    mark("train parity")
    out["seconds"] = seconds
    log(f"moe phase seconds by part: {seconds}")
    return out


# ---------------------------------------------------------------------------
# The frontends: whisper-large-v3's encoder-decoder over stub frames and
# qwen2-vl-2b's patch span with M-RoPE, each served at full width and depth
# and trained under RWSADMM.
WHISPER_ARCH = "whisper-large-v3"
VLM_ARCH = "qwen2-vl-2b"
#: the fp32 passes: whisper's first 4 encoder and 4 decoder layers, and
#: qwen2-vl's first 4 layers, with the same weights
FRONTEND_FP32_LAYERS = 4
#: RWSADMM at full width and depth in bf16: two clients on the walker, 4
#: rows a step of 448 decoder tokens (whisper's text context) after 1500
#: frames, or of 256 patches and 512 tokens; three rounds
WHISPER_TRAIN = dict(TRAIN, arch=WHISPER_ARCH, clients=2, seq=448, rounds=3)
VLM_TRAIN = dict(TRAIN, arch=VLM_ARCH, clients=2, seq=512, rounds=3)
#: the card-vs-CPU fp32 step: whisper cut to 1 encoder and 1 decoder layer
#: and 300 of its 1500 frames (the CPU's share of the phase's time);
#: qwen2-vl to 2 layers with its 256 patches
WHISPER_PARITY = dict(layers=1, cut=dict(encoder_layers=1, encoder_seq=300))
VLM_PARITY = dict(layers=2)


def encdec_decode(model, enc, ids, gen: int, max_len: int, *,
                  project: bool, greedy: bool = True):
    """``gen`` decode steps of an encoder-decoder from the encoder output
    ``enc``: greedy from ``ids[:, :1]`` through ``launch/serve.py``'s
    ``generate_encdec``, or teacher-forced on ``ids`` (B, ≥ gen). Returns
    the ids fed and chosen (B, gen + 1) and the logits (B, gen, vocab)."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_serve_step

    if greedy:
        out = list(serve.generate_encdec(model, enc, ids[:, :1], gen,
                                         max_len, project=project))
        return (torch.cat([ids[:, :1]] + [t for t, _ in out], 1),
                torch.stack([lg for _, lg in out], 1))
    step = make_serve_step(model)
    cache = model.init_cache(ids.shape[0], max_len, enc, project=project)
    logits = []
    for j in range(gen):
        _, lg, cache = step(cache, ids[:, j:j + 1])
        logits.append(lg)
    return ids, torch.stack(logits, 1)


def serve_encdec(model, label: str, *, project: bool,
                 teacher_bound: float | None = None) -> dict:
    """``SERVE``'s batch on an encoder-decoder: the stub frames encoded
    once (no hand kernel), then ``SERVE["gen"]`` greedy decode steps from
    each row's first token on one cross-attention path: exactly one
    ``flash_decode`` launch a decoder layer and step on the recompute
    path, two (self and cross) on the projected one, and no other kernel;
    the decode logits against a teacher-forced ``apply`` at the dtype's
    bound; encode ms, decode ms a step, tokens/s and peak memory."""
    import torch

    from repro_torch.models.registry import random_batch

    cfg = model.cfg
    bsz, gen = SERVE["batch"], SERVE["gen"]
    max_len = SERVE["prompt"] + gen
    batch = random_batch(cfg, bsz, SERVE["prompt"], seed=SERVE["seed"],
                         device=model.device)
    with torch.no_grad():    # warm-up, uncounted
        encdec_decode(model, model.encode(batch["frames"]), batch["tokens"],
                      2, max_len, project=project)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        enc = model.encode(batch["frames"])
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    after_encode = launch_counts()
    ids, logits = encdec_decode(model, enc, batch["tokens"], gen, max_len,
                                project=project)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0 - t_enc
    counts = launch_counts()
    per_step = cfg.n_layers * (2 if project else 1)
    want_encode = {n: 0 for n in _wrappers()}
    want_total = want_encode | {"flash_decode": per_step * gen}
    row = {"layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
           "dtype": cfg.dtype, "project": project,
           "encode_ms": t_enc * 1e3, "decode_ms_per_step": t_dec / gen * 1e3,
           "tok_per_s": bsz * gen / t_dec,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": {"flash_decode": counts["flash_decode"]},
           "flash_per_step": counts["flash_decode"] / gen,
           "ids": ids.tolist(), "ids_row0": ids[0].tolist()}
    log(f"{label}: {cfg.encoder_layers}+{cfg.n_layers} layers {cfg.dtype} "
        f"{'projected' if project else 'recompute'} cross path: encode "
        f"{bsz}x{cfg.encoder_seq} frames in {row['encode_ms']:.1f} ms, "
        f"{gen} decode steps at {row['decode_ms_per_step']:.2f} ms a step, "
        f"{row['tok_per_s']:.1f} tok/s over the decode, peak allocated "
        f"{row['peak_gib']:.2f} GiB, launches {counts} "
        f"({row['flash_per_step']:.0f} flash a step); ids row 0 "
        f"{row['ids_row0']}")
    if (after_encode != want_encode or counts != want_total
            or tuple(ids.shape) != (bsz, gen + 1)
            or not bool(logits.isfinite().all())):
        raise AssertionError(f"{label}: launches after encode {after_encode} "
                             f"(want {want_encode}), after decode {counts} "
                             f"(want {want_total}), ids {tuple(ids.shape)}, "
                             f"finite logits "
                             f"{bool(logits.isfinite().all())}")
    with torch.no_grad():
        forced = model.apply({"frames": batch["frames"],
                              "tokens": ids[:, :gen]})
    row["teacher"] = logit_errors(logits, forced)
    del forced
    hold_teacher(row["teacher"], cfg.dtype, gen, teacher_bound)
    row["logits"] = logits
    return row


def hold_cross_paths(recompute: dict, projected: dict, label: str) -> dict:
    """The projected cross path's decode against the recompute path's:
    the projected path's logits teacher-forced on the recompute path's ids
    (so a greedy near-tie cannot part their inputs) at the dtype's
    teacher bound, and the share of equal greedy ids."""
    import torch

    a, b = recompute["logits"], projected["logits"]
    same = float((torch.tensor(recompute["ids"])
                  == torch.tensor(projected["ids"])).float().mean())
    row = logit_errors(b, a) | {"ids_equal_share": same}
    log(f"{label}: projected vs recompute cross path over the recompute "
        f"path's ids: relative RMS per position "
        f"{' '.join(f'{e:.2e}' for e in row['rel_rms'])}, max abs "
        f"{row['max_abs']:.4g}, greedy ids equal {same:.3f}")
    return row


def whisper_paths(model, label: str, bound: float | None = None) -> dict:
    """Both cross paths on ``model`` (``serve_encdec``), then the projected
    path teacher-forced on the recompute path's ids against it at the
    dtype's teacher bound."""
    import torch

    from repro_torch.models.registry import random_batch

    out = {"recompute": serve_encdec(model, f"{label} recompute",
                                     project=False, teacher_bound=bound),
           "projected": serve_encdec(model, f"{label} projected",
                                     project=True, teacher_bound=bound)}
    cfg = model.cfg
    batch = random_batch(cfg, SERVE["batch"], SERVE["prompt"],
                         seed=SERVE["seed"], device=model.device)
    ids = torch.tensor(out["recompute"]["ids"], device=model.device)
    with torch.no_grad():
        _, forced = encdec_decode(model, model.encode(batch["frames"]), ids,
                                  SERVE["gen"], SERVE["prompt"] + SERVE["gen"],
                                  project=True, greedy=False)
    out["projected"]["logits"] = forced
    out["paths"] = hold_cross_paths(out["recompute"], out["projected"], label)
    hold_teacher(out["paths"], cfg.dtype, SERVE["gen"], bound,
                 "projected vs recompute cross path")
    for path in ("recompute", "projected"):
        del out[path]["logits"]
    return out


def phase_whisper(device) -> dict:
    """whisper-large-v3 at full width and depth (32 encoder and 32 decoder
    layers, d 1280, H = K = 20, hd 64), bf16, seeded random weights:
    ``serve.main``'s encoder-decoder branch (the recompute cross path:
    encode 4 × 1500 stub frames once, 16 greedy steps from each row's
    first token; exactly 32 flash-decode launches a step and no other
    kernel); the same generation on both cross paths with the same
    weights, each held to a teacher-forced ``apply`` and the projected
    path to the recompute path (64 launches a step: 32 self, 32 cross); a
    profiled encode and decode step on each path; the first 4 + 4 layers
    again in fp32; RWSADMM training at full width and depth
    (``WHISPER_TRAIN``) and a card-vs-CPU fp32 step on a cut
    (``WHISPER_PARITY``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.registry import random_batch

    seconds, last = {}, [time.perf_counter()]

    def mark(label: str) -> None:   # the phase's seconds by part
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[label] = round(now - last[0], 1)
        last[0] = now

    torch.cuda.empty_cache()
    gen = SERVE["gen"]
    zero_launch_counts()
    with counts_from_after_init() as inits:
        ids = serve.main(["--arch", WHISPER_ARCH, "--batch",
                          str(SERVE["batch"]), "--prompt-len",
                          str(SERVE["prompt"]), "--gen", str(gen), "--seed",
                          str(SERVE["seed"])])
    counts = launch_counts()
    torch.cuda.empty_cache()
    out = {"serve_main": {"ids_row0": ids[0].tolist(), "launches": counts}}
    log(f"whisper: serve.main --arch {WHISPER_ARCH}: ids {tuple(ids.shape)}, "
        f"launches after its init {counts} (the init's threefry_bits "
        f"{inits})")
    want = {n: 0 for n in _wrappers()} | {
        "flash_decode": get_config(WHISPER_ARCH).n_layers * gen}
    if counts != want or tuple(ids.shape) != (SERVE["batch"], gen + 1) \
            or len(inits) != 1:
        raise AssertionError(f"whisper serve.main: launches {counts} (want "
                             f"{want}), ids {tuple(ids.shape)}")
    mark("serve.main")
    t0 = time.perf_counter()
    model = serve.load_model(WHISPER_ARCH, device=device, seed=SERVE["seed"])
    torch.cuda.synchronize()
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    out |= {"params": n_params, "param_count": cfg.param_count(),
            "init_s": note_init(WHISPER_ARCH, time.perf_counter() - t0),
            "allocated_gib": torch.cuda.memory_allocated() / 2**30}
    log(f"whisper: {WHISPER_ARCH} {cfg.encoder_layers} encoder and "
        f"{cfg.n_layers} decoder layers, d {cfg.d_model}, H {cfg.n_heads} "
        f"over K {cfg.n_kv_heads}, hd {cfg.hd}, {cfg.encoder_seq} frames, "
        f"vocab {cfg.vocab}, {n_params:,} params ({cfg.param_count():,} by "
        f"param_count), {cfg.dtype}, init {out['init_s']:.2f} s, "
        f"{out['allocated_gib']:.2f} GiB")
    mark("init")
    out |= whisper_paths(model, WHISPER_ARCH)
    if out["recompute"]["ids"] != ids.tolist():
        raise AssertionError("whisper: the recompute path's ids differ from "
                             "serve.main's")
    mark("serve")
    batch = random_batch(cfg, SERVE["batch"], SERVE["prompt"],
                         seed=SERVE["seed"], device=device)
    tok = batch["tokens"][:, :1]
    with torch.no_grad():
        out["encode_profile"] = profile_breakdown(
            lambda: model.encode(batch["frames"]), 1, f"{WHISPER_ARCH} encode")
        enc = model.encode(batch["frames"])
        for project in (False, True):
            cache = model.init_cache(SERVE["batch"], SERVE["prompt"] + gen,
                                     enc, project=project)
            _, cache = model.decode_step(cache, tok)
            path = "projected" if project else "recompute"
            out[path]["decode_step_profile"] = profile_breakdown(
                lambda: model.decode_step(cache, tok), 3,
                f"{WHISPER_ARCH} decode step, {path} cross path")
            del cache
    del enc
    mark("profile")
    model = as_float32(model, FRONTEND_FP32_LAYERS)
    torch.cuda.empty_cache()
    out["float32"] = whisper_paths(model, f"{WHISPER_ARCH} fp32")
    del model
    torch.cuda.empty_cache()
    mark("fp32")
    out["train"] = train_on_walker(device, WHISPER_TRAIN, "whisper train")
    torch.cuda.empty_cache()
    mark("train")
    out["train"]["parity"] = lm_step_parity(
        device, WHISPER_ARCH, WHISPER_PARITY["layers"],
        cut=WHISPER_PARITY["cut"])
    mark("train parity")
    out["seconds"] = seconds
    log(f"whisper phase seconds by part: {seconds}")
    return out


def phase_vlm(device) -> dict:
    """qwen2-vl-2b at full width and depth (28 layers, d 1536, H 12 over K
    2, hd 128, qkv bias drawn at ``QKV_BIAS_SCALE``, M-RoPE θ 1e6), bf16,
    seeded random weights, through ``launch/serve.py``: 256 stub patches
    through the projector ahead of the 2040-token prompt (2296 positions,
    max_len 2312), 15 greedy decode steps, exactly 28 × 15 = 420
    flash-decode launches and no other kernel, the teacher check over
    patches, prompt and ids, a profiled prefill and decode step; its
    first 4 layers again in fp32; RWSADMM training at full width and
    depth (``VLM_TRAIN``) and a 2-layer fp32 step card vs CPU."""
    import torch

    from repro_torch.launch import serve

    seconds, last = {}, [time.perf_counter()]

    def mark(label: str) -> None:   # the phase's seconds by part
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[label] = round(now - last[0], 1)
        last[0] = now

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = serve.load_model(VLM_ARCH, device=device, seed=SERVE["seed"])
    gen_b = torch.Generator().manual_seed(SERVE["seed"])
    with torch.no_grad():
        for blk in model.layers:
            for b in (blk.mix.bq, blk.mix.bk, blk.mix.bv):
                b.copy_(torch.randn(b.shape, generator=gen_b)
                        * QKV_BIAS_SCALE)
    torch.cuda.synchronize()
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    out = {"params": n_params, "param_count": cfg.param_count(),
           "init_s": note_init(VLM_ARCH, time.perf_counter() - t0),
           "allocated_gib": torch.cuda.memory_allocated() / 2**30}
    log(f"vlm: {VLM_ARCH} {cfg.n_layers} layers, d {cfg.d_model}, H "
        f"{cfg.n_heads} over K {cfg.n_kv_heads}, hd {cfg.hd}, rope "
        f"{cfg.rope} theta {cfg.rope_theta}, {cfg.n_patches} patches, vocab "
        f"{cfg.vocab}, {n_params:,} params ({cfg.param_count():,} by "
        f"param_count), {cfg.dtype}, init {out['init_s']:.2f} s, "
        f"{out['allocated_gib']:.2f} GiB")
    mark("init")
    out |= serve_lm(model, VLM_ARCH)
    if out["launches"]["flash_decode"] != cfg.n_layers * (SERVE["gen"] - 1):
        raise AssertionError(f"vlm: flash launches {out['launches']}")
    mark("serve")
    out |= profile_serve(model, VLM_ARCH)
    mark("profile")
    model = as_float32(model, FRONTEND_FP32_LAYERS)
    torch.cuda.empty_cache()
    out["float32"] = serve_lm(model, f"{VLM_ARCH} fp32")
    del model
    torch.cuda.empty_cache()
    mark("fp32")
    out["train"] = train_on_walker(device, VLM_TRAIN, "vlm train")
    torch.cuda.empty_cache()
    mark("train")
    out["train"]["parity"] = lm_step_parity(device, VLM_ARCH,
                                            VLM_PARITY["layers"])
    mark("train parity")
    out["seconds"] = seconds
    log(f"vlm phase seconds by part: {seconds}")
    return out


# ---------------------------------------------------------------------------
# RecurrentGemma-9B trained under RWSADMM: the scan's forward and backward
# kernels in every RG-LRU layer of the step.
#: one (rglru, rglru, local) group at full width, bf16 (1,554,071,552
#: parameters by ``param_count``): 2 clients, 2 × 2048 tokens a step (the
#: local window), 3 rounds. A step launches the forward kernel twice an
#: RG-LRU layer (the forward, and its recompute in backward under
#: ``transformer._remat``) and the backward kernel once; no flash decode.
RG_CUT = dict(layer_pattern=("rglru", "rglru", "local"), n_layers=3)
RG_TRAIN = dict(TRAIN, arch=LM_ARCH, cut=RG_CUT, clients=2, batch=2,
                seq=2048, rounds=3,
                launches={"rglru_scan": 4, "rglru_scan_bwd": 2})
#: the backward kernel's shape in that step
RG_TRAIN_SCAN = (RG_TRAIN["batch"], RG_TRAIN["seq"], 4096)
#: the card-vs-CPU fp32 step of the same cut on 1 × 64 tokens (cut from
#: 128 to keep the smoke in its time): the CPU's time goes to the
#: 256,000-wide logits and the update of 1.55 B params
RG_PARITY_SHAPE = (1, 64)
#: the training driver on the card, on the reduced config (19 layers, 13
#: of them RG-LRU)
RG_DRIVER = dict(clients=4, rounds=4, batch=2, seq=64)


def phase_recurrentgemma_train(device) -> dict:
    """RecurrentGemma-9B's (rglru, rglru, local) cut trained at full width
    (``train_on_walker`` at ``RG_TRAIN``, the scan's launches gated
    exactly, every forward on the staged path), a fp32 step of the same
    cut card vs CPU, and ``python -m repro_torch.launch.train --arch
    recurrentgemma-9b --reduced`` (its ``main``) on the card, with its
    launches gated exactly too."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as driver

    seconds, t0 = {}, time.perf_counter()
    row = train_on_walker(device, RG_TRAIN, "recurrentgemma train")
    by_path = row["launches_by_path"]
    if any(by_path[k]["staged"] != row["launches"][k]
           for k in ("rglru_scan", "rglru_scan_bwd")):
        raise AssertionError(f"recurrentgemma train: scan paths {by_path}")
    seconds["train"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    row["parity"] = lm_step_parity(
        device, LM_ARCH, RG_CUT["n_layers"],
        cut={"layer_pattern": RG_CUT["layer_pattern"]},
        shape=RG_PARITY_SHAPE)
    seconds["train parity"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    d = RG_DRIVER
    argv = ["--arch", LM_ARCH, "--reduced"] + [
        a for k, v in d.items() for a in (f"--{k}", str(v))]
    zero_launch_counts()
    t0 = time.perf_counter()
    with counts_from_after_init() as inits:
        visits, losses = driver.main(argv)
        torch.cuda.synchronize()
    seconds["driver"] = time.perf_counter() - t0
    n_rglru = get_config(LM_ARCH).reduced().layer_pattern.count("rglru")
    counts, by_path = launch_counts(), path_counts()
    want = {n: 0 for n in counts} | {
        "rglru_scan": 2 * n_rglru * d["rounds"],
        "rglru_scan_bwd": n_rglru * d["rounds"]}
    want_paths = {k: {"staged": want[k], "loop": 0} for k in by_path}
    row["driver"] = {"argv": argv, "visits": visits, "losses": losses,
                     "seconds": seconds["driver"], "launches": counts,
                     "launches_by_path": by_path,
                     "init_threefry_bits": inits}
    log(f"recurrentgemma train: python -m repro_torch.launch.train "
        f"{' '.join(argv)}: visits {visits}, losses {losses}, "
        f"{seconds['driver']:.2f} s, launches after its init {counts} "
        f"(want {want}), by path {by_path}; the init's threefry_bits "
        f"launches {inits}")
    if counts != want or by_path != want_paths or len(inits) != 1 or \
            not all(np.isfinite(losses)) or len(visits) != d["rounds"]:
        raise AssertionError(f"train driver: {row['driver']} (want "
                             f"launches {want})")
    row["seconds"] = seconds
    log(f"recurrentgemma train phase seconds by part: {seconds}")
    return row


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Meshes: the client plane under a one-rank "data" mesh, kimi-k2-1t-a32b
# cut to one layer at full width under a one-rank ("data", "model") mesh,
# and the dry-run on a fake 256-rank group. Each part that starts a
# process group runs in a process of its own.
KIMI_ARCH = "kimi-k2-1t-a32b"
#: kimi-k2-1t-a32b at full width (d 7168, H 64 over K 8, hd 112, 384
#: experts top-8 of width 2048 and one shared expert, vocab 163,840,
#: bf16) cut to one layer: 19,422,670,848 parameters, 36.2 GiB; served at
#: batch 1, a 64-token prompt and 8 new tokens
KIMI = dict(layers=1, batch=1, prompt=64, gen=8, seed=0)
#: the no-drop teacher pass: capacity factor E/k = 48 makes each
#: expert's capacity T
KIMI_NO_DROP = 48.0
#: the bf16 teacher bound of that pass: twice the reference's own largest
#: gap on kimi's reduced config with its routing width put back (384
#: experts, top-8, one shared expert; d 256) at the served depth, one
#: layer, over seeds 0-4 and the serve's 64 + 8 tokens on the CPU:
#: 6.08e-3 (seed 1; the others 1.2e-7-1.4e-7)
#: (``tests/test_torch_moe_probe.py --arch kimi-k2-1t-a32b --layers 1
#: --prompt 64 --gen 8``). Deeper, the reference's own gap grows: 6.6e-3-
#: 1.0e-2 at 4 layers, 6.3e-2-6.9e-2 at 16.
KIMI_BF16_TEACHER = 0.0122
#: flash decode at kimi's decode shape: B 1, H 64 over K 8 (G = 8), hd
#: 112, the serve's 72-slot cache
KIMI_FLASH = dict(b=1, h=64, kv=8, hd=112, s=72)
#: the dry-run the card's torch runs: qwen3-moe-30b-a3b train_4k on the
#: (16, 16) fake mesh, and the reference's rule count of its parameters'
#: bytes a rank
MESH_DRYRUN = dict(arch="qwen3-moe-30b-a3b", shape="train_4k",
                   param_bytes_per_rank=285_622_272)


def kimi_flash_checks(device, card: str) -> list:
    """Flash decode at ``KIMI_FLASH`` in bf16 (the serve's last step timed
    cold and warm beside SDPA and the bound) and fp32, and with ragged
    lengths; each row marked ``kimi``."""
    g = KIMI_FLASH
    rows = []
    for dtype in ("bfloat16", "float32"):
        for lengths in ([g["s"]], [g["s"] - 9]):
            timed = dtype == "bfloat16" and lengths[0] == g["s"]
            rows.append(check_flash_decode(
                g["b"], g["h"], g["kv"], g["hd"], g["s"], lengths, None,
                dtype, device, card, timed) | {"kimi": True})
    return rows


def run_worker(part: str, timeout: int = 600) -> dict:
    """``mesh_worker(part)`` in a process of its own (its process group,
    its peak memory); returns the JSON object it printed last."""
    t0 = time.perf_counter()
    code = ("import sys; sys.path[:0] = ['src', '.']; import chip_smoke; "
            f"chip_smoke.mesh_worker({part!r})")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE,
                         capture_output=True, text=True, timeout=timeout,
                         env={**os.environ, "PYTHONPATH":
                              os.path.join(HERE, "src")})
    for line in out.stdout.splitlines():
        if not line.startswith("{"):
            print(line, flush=True)
    if out.returncode != 0:
        raise AssertionError(f"mesh worker {part} failed ({out.returncode})"
                             f": {out.stdout[-2000:]} {out.stderr[-4000:]}")
    row = json.loads(out.stdout.strip().splitlines()[-1])
    row["seconds"] = round(time.perf_counter() - t0, 1)
    return row


def mesh_worker(part: str) -> None:
    """One part of the mesh phase, in its own process: ``fl`` or
    ``kimi``. Prints its JSON object last."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    out = {"fl": mesh_fl, "kimi": mesh_kimi}[part](device)
    print(json.dumps(out, default=str), flush=True)


def end_leaves(trainer) -> list:
    """A run's end state (the trainer's carry), every tensor."""
    from repro_torch.fl.rwsadmm_trainer import _leaves

    return _leaves(trainer._carry)


def mesh_fl(device) -> dict:
    """The main path's CNN single walker (``MAIN``: 50 rounds of
    ``scan_fused`` in one captured window), the K = 3 fleet (``FLEET``'s
    50 wall steps) and the lazy single walker (capacity 40, 2 windows of
    4) each run without a mesh and under ``make_data_mesh()``'s one-rank
    mesh, cuDNN deterministic: round metrics, history and end state
    equal bit for bit, and the same launches (51 zone or multi-zone
    updates and 51 draws a run)."""
    import torch

    from repro_torch.data import factory_from_federated
    from repro_torch.launch.mesh import make_data_mesh

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = make_data_mesh()
    seed = MAIN["seed"]
    model, data, hp = build_main_path(device, seed)
    factory = factory_from_federated(main_fed(seed))
    cells = {
        "single walker": (lambda **kw: make_trainer(model, data, hp, device,
                                                    seed, **kw),
                          MAIN["rounds"], "zone_update", None),
        "fleet simultaneous": (lambda **kw: make_fleet(
            model, data, hp, device, seed, **kw), FLEET["wall_steps"],
            "multizone_update", None),
        "lazy single walker": (lambda **kw: make_trainer(
            model, factory, hp, device, seed,
            store_capacity=LAZY["capacity"], **kw), 2 * LAZY["window"],
            "zone_update", LAZY["window"])}
    out = {"world_size": torch.distributed.get_world_size()}
    for label, (make, rounds, update, window) in cells.items():
        runs = []
        for m in (None, mesh):
            tr = make(mesh=m)
            res, counts, _, losses, _ = drive(tr, rounds, seed, update,
                                              f"{label} mesh {m is not None}",
                                              window=window)
            runs.append((res, counts, end_leaves(tr)))
        (r0, c0, s0), (r1, c1, s1) = runs
        same = {"round_metrics": r0.round_metrics == r1.round_metrics,
                "history": r0.history == r1.history,
                "end_state": len(s0) == len(s1) and all(
                    torch.equal(a, b) for a, b in zip(s0, s1)),
                "launches": c0["counts"] == c1["counts"]
                and c0["ran"] == c1["ran"]}
        out[label] = {"same": same, "launches": c1["counts"],
                      "launches_run": c1["ran"], "rounds": rounds}
        log(f"mesh {label}: one-rank mesh vs none over {rounds} rounds: "
            f"{same}; launches {c1['counts']}, run {c1['ran']}")
        if not all(same.values()):
            raise AssertionError(f"mesh {label}: the one-rank mesh differs "
                                 f"from the meshless run: {same}")
    return out


def mesh_kimi(device) -> dict:
    """kimi-k2-1t-a32b at full width cut to one layer (``KIMI``), bf16,
    weights drawn on the card at the seed: served through
    ``launch/serve.py`` without a mesh and under a one-rank ("data",
    "model") mesh through ``ShardingCtx`` (ZeRO-3 expert storage, one
    shard): ids and logits bit for bit equal and 7 flash-decode launches
    each; then the no-drop teacher check (capacity factor 48) at
    ``KIMI_BF16_TEACHER``. Init seconds, prefill and decode ms, peak
    memory."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_data_mesh, make_debug_mesh
    from repro_torch.models.registry import random_batch
    from repro_torch.models.transformer import LM, ShardingCtx

    cfg = dataclasses.replace(get_config(KIMI_ARCH), n_layers=KIMI["layers"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = LM(cfg, device=device).init(KIMI["seed"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weights_gib = torch.cuda.memory_allocated() / 2**30
    b, prompt, gen = KIMI["batch"], KIMI["prompt"], KIMI["gen"]
    max_len = prompt + gen
    batch = random_batch(cfg, b, prompt, seed=KIMI["seed"], device=device)
    e = cfg.moe
    log(f"kimi: {KIMI_ARCH} cut to {cfg.n_layers} layer at full width (d "
        f"{cfg.d_model}, H {cfg.n_heads} over K {cfg.n_kv_heads}, hd "
        f"{cfg.hd}, {e.n_experts} experts top-{e.top_k} width "
        f"{e.d_expert}, {e.n_shared_experts} shared, vocab {cfg.vocab}), "
        f"{n_params:,} params, {cfg.dtype}, drawn in {init_s:.2f} s, "
        f"{weights_gib:.2f} GiB")

    def serve_once(m, label):
        for _ in serve.generate(m, {"tokens": batch["tokens"][:, :8]}, 2,
                                10):
            pass    # warm-up, uncounted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        t0 = time.perf_counter()
        steps = serve.generate(m, batch, gen, max_len)
        first = next(steps)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        rest = list(steps)
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
        counts = launch_counts()
        ids = torch.cat([first[0]] + [t for t, _ in rest], 1)
        logits = torch.stack([first[1]] + [lg for _, lg in rest], 1)
        row = {"prefill_ms": t_prefill * 1e3,
               "decode_ms_per_step": (t_total - t_prefill) / (gen - 1) * 1e3,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": counts, "ids": ids[0].tolist()}
        want = {n: 0 for n in counts} | {"flash_decode": gen - 1}
        log(f"kimi {label}: prefill {b}x{prompt} in {row['prefill_ms']:.1f}"
            f" ms, {gen - 1} decode steps at {row['decode_ms_per_step']:.2f}"
            f" ms a step, peak {row['peak_gib']:.2f} GiB, launches {counts},"
            f" ids {row['ids']}")
        if counts != want or not bool(logits.isfinite().all()):
            raise AssertionError(f"kimi {label}: launches {counts} (want "
                                 f"{want}), finite "
                                 f"{bool(logits.isfinite().all())}")
        return row, ids, logits

    out = {"params": n_params, "init_s": init_s, "weights_gib": weights_gib}
    out["meshless"], ids0, logits0 = serve_once(model, "no mesh")
    make_data_mesh()          # the one-rank NCCL group
    ctx = ShardingCtx(mesh=make_debug_mesh(1, 1), zero3_moe=True)
    par = LM(cfg, ctx, device="meta")
    par.load_state_dict(model.state_dict(), assign=True)
    out["mesh"], ids1, logits1 = serve_once(par, "(1, 1) mesh")
    out["mesh_equal"] = bool(torch.equal(ids0, ids1)
                             and torch.equal(logits0, logits1))
    if not out["mesh_equal"]:
        raise AssertionError("kimi: the (1, 1) mesh's ids or logits differ "
                             "from the meshless serve's")
    del par, logits1
    nd = with_capacity_factor(model, KIMI_NO_DROP)
    row, ids, logits = serve_once(nd, f"capacity factor {KIMI_NO_DROP}")
    out["no_drop"] = row
    out["teacher"] = teacher_forced_errors(nd, batch["tokens"], ids, logits)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    hold_teacher(out["teacher"], cfg.dtype, max_len, KIMI_BF16_TEACHER)
    return out


def start_dryrun(out_dir: str) -> subprocess.Popen:
    """``python -m repro_torch.launch.dryrun`` at ``MESH_DRYRUN`` in its
    own process (the fake 256-rank group, on the host's CPU only), started
    now and read by :func:`mesh_dryrun`."""
    g = MESH_DRYRUN
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         g["arch"], "--shape", g["shape"], "--out", out_dir],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": os.path.join(HERE, "src")})


def mesh_dryrun(proc: subprocess.Popen, out_dir: str, t0: float) -> dict:
    """The dry-run :func:`start_dryrun` started at ``t0``: the parameters'
    bytes a rank equal the reference's rule count, the record holds the
    expert partials' reduction over "model" and the ZeRO-3 gathers, and
    no CUDA context was made."""
    g = MESH_DRYRUN
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    if proc.returncode != 0:
        raise AssertionError(f"dry-run failed ({proc.returncode}): "
                             f"{stdout[-2000:]} {stderr[-3000:]}")
    with open(os.path.join(out_dir, f"{g['arch']}__{g['shape']}__pod1.json")
              ) as f:
        rec = json.load(f)
    from repro_torch.launch.roofline_report import roofline_row

    moe = rec["moe_collectives"]
    row = {k: rec.get(k) for k in (
        "n_chips", "dtype", "flops", "flops_per_rank", "param_bytes_per_rank",
        "argument_bytes_per_rank", "temp_bytes_per_rank",
        "peak_bytes_per_rank", "bytes_accessed_per_rank", "collectives",
        "moe_collectives", "device_type", "cuda_initialized",
        "peak_rss_bytes")}
    roof = roofline_row(rec)
    row["roofline"] = {k: roof[k] for k in (
        "t_compute_s", "t_compute_even_s", "t_memory_s", "t_collective_s",
        "dominant", "useful_ratio", "step_time_s", "peak_flops", "hbm_bw",
        "link_bw")}
    row["run_seconds"] = rec["seconds"]
    row["seconds"] = round(time.perf_counter() - t0, 1)
    log(f"dry-run {g['arch']} {g['shape']} on {rec['n_chips']} fake ranks "
        f"({rec['device_type']} group, torch here): params "
        f"{rec['param_bytes_per_rank']:,} B a rank (reference "
        f"{g['param_bytes_per_rank']:,}), arguments "
        f"{rec['argument_bytes_per_rank']}, flops {rec['flops']:.4e} "
        f"global, {rec['flops_per_rank']:.4e} a rank, collectives "
        f"{rec['collectives']}, of them in the MoE layers {moe}, CUDA "
        f"context made: {rec['cuda_initialized']}, peak RSS "
        f"{rec['peak_rss_bytes']} B (VmHWM; None: not reported), "
        f"{row['seconds']} s")
    log(f"dry-run {g['arch']} {g['shape']}: temporaries "
        f"{rec.get('temp_bytes_per_rank')} B a rank, peak "
        f"{rec.get('peak_bytes_per_rank')} B, bytes accessed "
        f"{rec.get('bytes_accessed_per_rank')} a rank; roofline at the "
        f"H100's constants: {row['roofline']}")
    if (not rec.get("temp_bytes_per_rank")
            or not rec.get("bytes_accessed_per_rank")
            or rec["param_bytes_per_rank"] != g["param_bytes_per_rank"]
            or not moe.get("all-reduce", {}).get("count")
            or not moe.get("all-gather", {}).get("count")
            or rec["cuda_initialized"]):
        raise AssertionError(f"dry-run record fails its gates: {row}")
    return row


def phase_mesh(device) -> dict:
    """The mesh phase: the dry-run (host CPU only) started in its own
    process, ``mesh_fl`` and ``mesh_kimi`` in processes of their own
    meanwhile, then the dry-run's record read."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        dry = start_dryrun(td)
        try:
            out = {"fl": run_worker("fl"), "kimi": run_worker("kimi", 900)}
        except BaseException:
            dry.kill()
            dry.wait()
            raise
        out["dryrun"] = mesh_dryrun(dry, td, t0)
    return out


#: the analysis phase's real step for ``LiveBytes``: tinyllama-1.1b's
#: reduced config, fp32, a (batch, seq) token block
ANALYSIS_STEP = dict(arch="tinyllama-1.1b", batch=8, seq=1024, seed=0)


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``."""
    from torch.utils._pytree import tree_leaves

    sizes = {}
    for t in tree_leaves(tree):
        if hasattr(t, "untyped_storage"):
            s = t.untyped_storage()
            sizes[s._cdata] = s.nbytes()
    return sum(sizes.values())


def live_bytes_step(device) -> dict:
    """``LiveBytes`` on one real RWSADMM step on the card (``ANALYSIS_STEP``,
    after a warm-up step) beside the allocator's peak, both above what was
    allocated before the step: the tracker's peak must not exceed the
    allocator's (each storage is one allocation, rounded up)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.rwsadmm import RWSADMMHparams
    from repro_torch.launch.dryrun import LiveBytes
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models.registry import build_model

    g = ANALYSIS_STEP
    cfg = dataclasses.replace(get_config(g["arch"]).reduced(),
                              dtype="float32")
    model = build_model(cfg, device=device).init(g["seed"])
    hp = RWSADMMHparams(beta=10.0)
    params = {k: v.detach() for k, v in model.named_parameters()}
    tokens = np.random.default_rng(g["seed"]).integers(
        0, cfg.vocab, (g["batch"], g["seq"]))
    batch = {"tokens": torch.as_tensor(tokens, device=device)}
    step = make_train_step(model, hp)
    step(init_train_state(params, hp), batch)        # warm-up, unmeasured
    state = init_train_state(params, hp)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with LiveBytes(device) as live:
        new, loss = step(state, batch)
        torch.cuda.synchronize()
    allocator = torch.cuda.max_memory_allocated() - base
    row = {"step": f"{g['arch']} reduced fp32, {g['batch']} x {g['seq']} "
                   "tokens", "argument_bytes": storage_bytes((state, batch)),
           "tracker_peak_bytes": live.peak, "allocator_peak_bytes": allocator,
           "tracker_over_allocator": live.peak / allocator,
           "storages": live.created, "loss": float(loss)}
    log(f"analysis LiveBytes: {row['step']}: tracker peak {live.peak:,} B "
        f"above the arguments ({row['argument_bytes']:,} B), allocator "
        f"peak {allocator:,} B above what was allocated before; ratio "
        f"{row['tracker_over_allocator']:.4f}; {live.created} storages")
    if not live.peak <= allocator or not math.isfinite(row["loss"]):
        raise AssertionError(f"LiveBytes reads above the allocator: {row}")
    return row


def profiled_replay(trainer) -> dict:
    """One more replay of the trainer's ``scan_fused`` window under the
    profiler: the device activity it shows, and no device-to-host copy."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis.registry import CHUNK_ROUNDS

    state = trainer.init_state(0)
    sched = trainer.schedule(CHUNK_ROUNDS, np.random.default_rng(1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.run_chunk(state, sched, engine="scan_fused")
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    dtoh = [n for n in names if "DtoH" in n or "Device -> Host" in n
            or "Device -> Pageable" in n or "Device -> Pinned" in n]
    return {"device_events": len(names), "dtoh_copies": len(dtoh),
            "memcpy": sorted({n for n in names if "Memcpy" in n})}


def phase_analysis(device) -> dict:
    """The static analysis on the card: the capture budget's smoke cells
    (``repro_torch.analysis.capture_budget.measure_card``: each window
    captured once and replayed) against ``analysis/capture_budget_torch.
    json``, its captures and each window's captured kernel counts; the
    carry check over two more replays of each ``scan_fused`` window; one
    replay under the profiler with no device-to-host copy; ``LiveBytes``
    on a real step against the allocator."""
    from repro_torch.analysis import capture_budget as cb
    from repro_torch.analysis.registry import drive
    from repro_torch.analysis.window_audit import carry_aliasing

    golden = cb.load_golden(os.path.join(HERE, "analysis",
                                         "capture_budget_torch.json"))
    card = cb.measure_card(device)
    problems = (cb.compare_budget(card["captures"], golden["captures"])
                + cb.compare_windows(card["windows"], golden["windows"]))
    carry = []
    for spec, trainer in card["trainers"]:
        states = [drive(trainer, "scan_fused") for _ in range(2)]
        carry += [f.render() for f in carry_aliasing(trainer, states)]
    replay = profiled_replay(card["trainers"][0][1])
    out = {"captures": card["captures"], "golden": golden["captures"],
           "windows": card["windows"], "problems": problems,
           "carry_aliasing": carry, "profiled_replay": replay,
           "live_bytes": live_bytes_step(device)}
    log(f"analysis: captures {card['captures']} (golden "
        f"{golden['captures']}), windows {card['windows']}, drift "
        f"{problems or 'none'}; carry {carry or 'aliased in every replay'}; "
        f"profiled replay: {replay['device_events']} device events, "
        f"{replay['dtoh_copies']} device-to-host copies, memcpy kinds "
        f"{replay['memcpy']}")
    if (problems or carry or replay["dtoh_copies"]
            or not replay["device_events"]):
        raise AssertionError(f"analysis phase fails its gates: {out}")
    return out


_RW_SOURCE = "src/repro_torch/kernels/rwsadmm_update/csrc/zone_update.cu"
_TF_SOURCE = "src/repro_torch/kernels/threefry/csrc/threefry.cu"
SOURCE = {"zone_update": _RW_SOURCE, "multizone_update": _RW_SOURCE,
          "fused_update": _RW_SOURCE,
          "rglru_scan": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
          "rglru_scan_bwd":
              "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
          "flash_decode":
              "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
          "threefry_draws": _TF_SOURCE, "threefry_bits": _TF_SOURCE}
REPLACES = {"zone_update": "src/repro/kernels/rwsadmm_update/kernel.py:176",
            "multizone_update":
                "src/repro/kernels/rwsadmm_update/kernel.py:147",
            "fused_update": "src/repro/kernels/rwsadmm_update/kernel.py:51",
            "rglru_scan": "src/repro/kernels/rglru_scan/kernel.py:49",
            # No pl.pallas_call: XLA's transpose of the reference's
            # associative scan, linear_scan, under jax.grad.
            "rglru_scan_bwd": "src/repro/models/recurrent.py:91",
            "flash_decode": "src/repro/kernels/flash_decode/kernel.py:82",
            # No pl.pallas_call: jax.random, which XLA fuses into the
            # reference's round; the draws replace sample_batch's randint
            # (and the CNN's bernoulli, models/small.py:112, :120), the
            # bits the cohort's key split.
            "threefry_draws": "src/repro/fl/base.py:110",
            "threefry_bits": "src/repro/baselines/fedavg.py:43"}


#: seconds each phase took in this run, printed at the end
PHASE_SECONDS: dict = {}


def run_phase(label: str, fn, *args):
    """Run one phase, noting its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[label] = round(time.perf_counter() - t0, 1)
    log(f"phase {label}: {PHASE_SECONDS[label]} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels.rwsadmm_update import ops  # noqa: F401

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name} | {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | TF32 off")

    ptxas = run_phase("build", phase_build)
    model, data, hp = build_main_path(device, MAIN["seed"])
    rows = run_phase("kernels", phase_kernels, hp, device, name)
    rows.update(run_phase("lm kernels", phase_lm_kernels, device, name))
    rows.update(run_phase("threefry", phase_threefry, device, model, data, name))
    lm_init = run_phase("lm init", phase_lm_init, device, name)
    rows["threefry_bits"].append(lm_init["threefry_bits_init_block"])
    paths = {"main_path": run_phase("main path", phase_main_path, device, model,
                                data, hp),
             "fleet_path": run_phase("fleet path", phase_fleet, device, model,
                                 data, hp)}
    paths["scenarios"] = run_phase("scenarios", phase_scenarios, device, model,
                               data, hp, paths)
    paths["walks"] = run_phase("walks", phase_walks, device, model, data, hp,
                           paths)
    paths["lazy"] = run_phase("lazy", phase_lazy, device, model, data, hp)
    main_counts = paths["main_path"]["launches"]
    launches = {"zone_update": main_counts["zone_update"],
                "multizone_update":
                    paths["fleet_path"]["launches"]["multizone_update"],
                "fused_update": phase_single_client(device, model, data, hp),
                "threefry_draws": main_counts["threefry_draws"]}
    # The scenarios phase's own runs (each driven with the counts at 0):
    # the single walker under field_trial and the fleet under lossy_links.
    scn = [paths["scenarios"][k] for k in ("single walker",
                                          "fleet simultaneous")]
    scenario_launches = {k: sum(p["launches"].get(k, 0) for p in scn)
                         for k in ("zone_update", "multizone_update",
                                   "threefry_draws")}
    scenario_ran = {k: sum(p["launches_run"].get(k, 0) for p in scn)
                    for k in scenario_launches}
    # The walks phase's own runs, each driven with the counts at 0.
    walks = [paths["walks"][label] for label, *_ in WALK_RUNS]
    walk_launches = {k: sum(p["launches"].get(k, 0) for p in walks)
                     for k in scenario_launches}
    walk_ran = {k: sum(p["launches_run"].get(k, 0) for p in walks)
                for k in scenario_launches}
    # The lazy phase's own runs (the CNN single walker and fleet on the
    # store, each driven with the counts at 0), and the DP path's.
    lazy = [paths["lazy"][k] for k in ("single walker",
                                       "fleet simultaneous")]
    lazy_launches = {k: sum(p["launches"].get(k, 0) for p in lazy)
                     for k in scenario_launches}
    lazy_launches["threefry_bits"] = paths["lazy"]["dp"]["launches"][
        "threefry_bits"]
    lazy_ran = {k: sum(p["launches_run"].get(k, 0) for p in lazy)
                for k in scenario_launches}
    lazy_ran["threefry_bits"] = paths["lazy"]["dp"]["launches_run"][
        "threefry_bits"]
    ran = {"zone_update": paths["main_path"]["launches_run"]["zone_update"],
           "multizone_update":
               paths["fleet_path"]["launches_run"]["multizone_update"],
           "threefry_draws":
               paths["main_path"]["launches_run"]["threefry_draws"]}
    paths["capture"] = run_phase("capture", phase_capture, device, model, data,
                             hp)
    paths["device_parity"] = run_phase("device parity", phase_device_parity,
                                   device, model, data, hp)
    paths["twins"] = run_phase("twins", phase_twins, device)
    paths["baselines"] = run_phase("baselines", phase_baselines, device, model,
                               data)
    paths["paper_scripts"] = run_phase("paper scripts", phase_paper, device)
    # threefry_bits runs on the baselines' path (their key trees): its
    # launches over the accuracy gates' runs.
    launches["threefry_bits"] = sum(
        r["threefry"]["threefry_bits"]
        for r in paths["baselines"]["gates"].values())
    model = data = None
    torch.cuda.empty_cache()
    paths["serve_path"] = run_phase("serve", phase_serve, device)
    launches.update(paths["serve_path"]["launches"])
    paths["zoo_serve"] = run_phase("zoo serve", phase_zoo_serve, device)
    paths["train"] = run_phase("train", phase_train, device)
    paths["xlstm"] = run_phase("xlstm", phase_xlstm, device)
    paths["moe"] = run_phase("moe", phase_moe, device)
    paths["whisper"] = run_phase("whisper", phase_whisper, device)
    paths["vlm"] = run_phase("vlm", phase_vlm, device)
    paths["recurrentgemma_train"] = run_phase(
        "recurrentgemma train", phase_recurrentgemma_train, device)
    torch.cuda.empty_cache()
    paths["mesh"] = run_phase("mesh", phase_mesh, device)
    paths["analysis"] = run_phase("analysis", phase_analysis, device)
    # the scan's backward on its main path: the full-width training run,
    # driven with the counts at 0 (the forward's: the serve path's)
    rg_train = paths["recurrentgemma_train"]
    launches["rglru_scan_bwd"] = rg_train["launches"]["rglru_scan_bwd"]
    # flash_decode on the zoo's serve paths, each driven with the counts at
    # 0: gemma3-12b bf16 at full depth, its fp32 pattern, the 2-layer cuts
    zoo = paths["zoo_serve"]
    zoo_launches = {"gemma3-12b": zoo[ZOO_ARCH]["launches"]["flash_decode"],
                    "gemma3-12b-fp32": zoo[ZOO_ARCH]["float32"]["launches"][
                        "flash_decode"]}
    zoo_launches.update({a: zoo[a]["launches"]["flash_decode"]
                         for a in ZOO_CUTS})
    moe_run = paths["moe"]
    moe_launches = {MOE_ARCH: moe_run["launches"]["flash_decode"],
                    f"{MOE_ARCH}-no-drop": moe_run["no_drop"]["launches"][
                        "flash_decode"],
                    f"{MOE_ARCH}-fp32": moe_run["float32"]["launches"][
                        "flash_decode"]}
    # flash_decode on the frontends' paths, each driven with the counts at 0
    wh, vl = paths["whisper"], paths["vlm"]
    frontend_launches = {
        f"{WHISPER_ARCH}-serve-main": wh["serve_main"]["launches"][
            "flash_decode"],
        **{f"{WHISPER_ARCH}-{path}{dt}": run[path]["launches"]["flash_decode"]
           for dt, run in (("", wh), ("-fp32", wh["float32"]))
           for path in ("recompute", "projected")},
        VLM_ARCH: vl["launches"]["flash_decode"],
        f"{VLM_ARCH}-fp32": vl["float32"]["launches"]["flash_decode"]}
    # the mesh phase's runs, each driven with the counts at 0 in its own
    # process: the client plane without and under the one-rank mesh, and
    # kimi-k2-1t-a32b's serves
    mesh = paths["mesh"]
    mesh_launches = {
        f"{label} {k}": mesh["fl"][label][k][update]
        for label, update in (("single walker", "zone_update"),
                              ("fleet simultaneous", "multizone_update"),
                              ("lazy single walker", "zone_update"))
        for k in ("launches", "launches_run")}
    kimi_launches = {f"{KIMI_ARCH}-1l-{k}": mesh["kimi"][k]["launches"][
        "flash_decode"] for k in ("meshless", "mesh", "no_drop")}

    # Every kernel's "ms" is its device time per call with a cold L2.
    extra = ("ms_warm", "graph_ms", "graph_ms_warm", "library_ms_warm",
             "library_graph_ms", "library_graph_ms_warm", "plain_ms_warm",
             "config", "path")
    kernels = []
    for kernel, checks in rows.items():
        timed = checks[0]
        row = {"name": kernel, "route": "cuda", "source": SOURCE[kernel],
               "replaces": REPLACES[kernel],
               "launches": launches.get(kernel),
               "launches_run": ran.get(kernel, launches.get(kernel)),
               "launches_scenarios": scenario_launches.get(kernel, 0),
               "launches_run_scenarios": scenario_ran.get(kernel, 0),
               "launches_walks": walk_launches.get(kernel, 0),
               "launches_run_walks": walk_ran.get(kernel, 0),
               "launches_lazy": lazy_launches.get(kernel, 0),
               "launches_run_lazy": lazy_ran.get(kernel, 0),
               "max_abs_err": max(r["max_abs_err"] for r in checks),
               "ms": timed["ms"], "plain_ms": timed["plain_ms"],
               "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
               "library_ms": timed.get("library_ms"),
               "share_of_bound": timed["share_of_bound"],
               "shape": timed["shape"]}
        row.update({k: timed[k] for k in extra if k in timed})
        if kernel in ("rglru_scan", "rglru_scan_bwd", "flash_decode",
                      *THREEFRY):
            row["ptxas"] = {e: v for e, v in ptxas.items()
                            if e.startswith(kernel) and (
                                kernel != "rglru_scan" or "_bwd" not in e)}
        if kernel in ("zone_update", "multizone_update"):
            row["launches_mesh"] = {k: v for k, v in mesh_launches.items()
                                    if ("fleet" in k) == (
                                        kernel == "multizone_update")}
        if kernel in ("rglru_scan", "rglru_scan_bwd"):
            row["launches_train"] = rg_train["launches"][kernel]
            row["launches_train_driver"] = rg_train["driver"]["launches"][
                kernel]
        if kernel == "rglru_scan_bwd":
            row["function_vs_autograd"] = timed["function_vs_autograd"]
            row["launches_by_path_train"] = rg_train["launches_by_path"][
                kernel]
        if kernel in ("rglru_scan", "rglru_scan_bwd"):
            # the other timed row: the forward at the training step's
            # shape; the backward's loop path there (a one float off)
            key = "train_shape" if kernel == "rglru_scan" else "loop_path"
            other = next(r for r in checks[1:] if "ms" in r)
            row[key] = {k: other[k] for k in (
                "shape", "path", "ms", "ms_warm", "graph_ms", "plain_ms",
                "bound_ms", "bound_by", "share_of_bound")}
        if kernel == "threefry_bits":
            row["init_block_shape"] = {k: checks[-1][k] for k in (
                "shape", "ms", "ms_warm", "graph_ms", "plain_ms",
                "bound_ms", "bound_by", "share_of_bound")}
        if "sign_flips" in timed:
            row["sign_flips"] = sum(r["sign_flips"] for r in checks)
        if kernel == "flash_decode":
            g3 = next(r for r in checks if r.get("gemma3") and "ms" in r)
            q3 = next(r for r in checks if r.get("qwen3") and "ms" in r)
            row["launches_zoo"] = zoo_launches
            row["launches_moe"] = moe_launches
            row["launches_frontends"] = frontend_launches
            row["launches_kimi"] = kimi_launches
            k3 = next(r for r in checks if r.get("kimi") and "ms" in r)
            shapes = [("gemma3_shape", g3), ("qwen3_shape", q3),
                      ("kimi_shape", k3)] + [
                (f"{key}_shape", next(r for r in checks
                                      if r.get(key) and "ms" in r))
                for key in FRONTEND_FLASH]
            for key, timed_row in shapes:
                row[key] = {k: timed_row[k] for k in (
                    "shape", "ms", "ms_warm", "graph_ms", "library_ms",
                    "library_ms_warm", "plain_ms", "bound_ms", "bound_by",
                    "share_of_bound", "config")}
        kernels.append(row)
    log(json.dumps({"kernels": kernels}))
    paths["lm_init"] = lm_init["inits"]
    for label, summary in paths.items():
        log(json.dumps({label: summary}, default=str))
    log(f"init seconds on the card (build and draw): {INIT_SECONDS}")
    log(f"phase seconds: {PHASE_SECONDS}")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
