"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device — needs CUDA; prints the card's name and power limit
   (``nvidia-smi``) and turns TF32 off for matmuls and convolutions.
2. build — builds the kernels from ``src/repro_torch`` with ``nvcc``, one
   process per source, all at once (four sources, seven kernels), and
   prints ptxas's registers, spills and static shared memory per entry.
3. kernels — holds each kernel against its plain PyTorch version on the
   card at the paths' shapes and at odd ones, and times the first row of
   each beside its bound: ``zone_update``, ``multizone_update`` and
   ``fused_update`` (padded slots and an idle walker included; bit for
   bit; the zone kernel also at every width, β and live count the Table
   1 grid gives it), ``rglru_scan`` (bit for bit, on both its paths) and
   ``flash_decode`` (fp32 at 1e-5, bf16 at atol 1e-3 + rtol 1e-2 against
   the plain softmax and the split reference; lengths below S, a window,
   a row with no valid key, every hd remainder of the tensor-core
   steps). Every kernel by device time over input sets that together
   exceed the L2 (cold) and over one set (warm), with CUDA-graph replay
   beside; one ``scaled_dot_product_attention`` call timed the same way
   as flash decode's yardstick. Then ``threefry`` (the port of
   ``jax.random``'s sampler): ``threefry_draws`` bit for bit against the
   plain integer ops at the zone's 8 leaves, the fleet's 24, prox-SGD's
   step-major tree, the edge spans and its one-output forms, and
   ``threefry_bits`` at split, fold-in and raw-bits shapes; one round's
   draws timed cold and warm beside their bound on the integer pipe (the
   SM clock read from ``nvidia-smi``), and a cohort's key split.
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
   within 5 % (its direct figure: the trace's own cost). A checkpoint
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
8. serve path — RecurrentGemma-9B at full width (bf16, seeded random
   weights) through ``launch/serve.py``: prefill 4 × 2040 tokens (one
   ``rglru_scan`` launch per RG-LRU layer, 26) and 15 greedy decode steps
   (one ``flash_decode`` launch per local layer and step, 180; the rings
   wrap at step 8), each kernel path's launches checked; then the decode
   logits against a teacher-forced ``apply`` over the same 2056 tokens, a
   profiled prefill and decode step, and the same generation and check in
   fp32, where the bound is tight enough to fail a fault in the ring.

Ends with a ``{"kernels": [...]}`` line, the paths' summaries, each
phase's seconds, the ``nvidia-smi`` line and, last, ``{"ok": true,
"device": {...}}``. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

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
# 32-bit integer add, bitwise, shift and funnel-shift results a clock per
# SM on compute capability 9.0 (CUDA C++ programming guide, throughput of
# arithmetic instructions), and the H100's SMs: times the SM clock that
# nvidia-smi reads, the integer pipe's peak.
INT32_OPS_PER_CLOCK_PER_SM = 64
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
    return rate, (f"{INT32_OPS_PER_CLOCK_PER_SM} int32 results a clock per "
                  f"SM × {H100_SMS} SMs × {mhz:.0f} MHz (nvidia-smi "
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


def device_time_ms(fns, reps: int, graph: bool = True) -> dict:
    """Device time of one call, each of ``fns`` being one call on its own
    inputs, run in turn ``reps`` times (distinct inputs larger than the
    50 MB L2 between them read it cold). ``profiler``: the kernels' own
    device time per call, summed from ``torch.profiler`` (no host gaps);
    ``graph``: one CUDA graph of all the calls replayed, elapsed CUDA-event
    time per call (back-to-back launches with the graph's own gaps)."""
    import torch

    for fn in fns:                   # warm: builds, attributes, plans
        fn()
    calls = len(fns) * reps
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    out = {"profiler": sum(e.self_device_time_total for e in rows)
           / calls / 1e3,
           "kernels_per_call": sum(e.count for e in rows) / calls,
           "by_kernel": {e.key[:80]: e.self_device_time_total / calls / 1e3
                         for e in rows}}
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
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.rwsadmm_update import ops
    from repro_torch.kernels.threefry import ops as tf

    return {"zone_update": ops.zone_fused_update,
            "multizone_update": ops.multizone_fused_update,
            "fused_update": ops.fused_update,
            "rglru_scan": rglru_scan, "flash_decode": flash_decode,
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
    """Launches of the scan by path: its ``staged`` or ``loop`` kernel."""
    return {"rglru_scan": dict(_wrappers()["rglru_scan"].launches_by_path)}


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
    log(f"build: 7 kernels from 4 sources in {seconds:.2f} s "
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
    cold = device_time_ms([lambda a=a: launch(*a, **kw) for a in sets], reps)
    warm = device_time_ms([lambda: launch(*sets[0], **kw)], 60)
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
#: 32-bit integer operations of one 32-bit threefry2x32 draw: 20 rounds of
#: add, rotate and xor (60), 2 + 5 × 2 key additions (a key's sums with
#: the injection numbers are made once per key) and the xor of the two
#: output words (1)
HASH_OPS = 73
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
    ops = (n_mask * (HASH_OPS + KEEP_OPS) + n_idx * (2 * HASH_OPS + INDEX_OPS)
           + key_hashes * HASH_OPS)
    return bytes_moved, ops, n_mask, n_idx


def bound(bytes_moved: int, ops: int, card: str) -> dict:
    """The least time for the work: bytes at the memory rate, 32-bit
    integer operations at the integer pipe's."""
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
    cold = device_time_ms([call(i) for i in range(sets)], 4)
    warm = device_time_ms([call(0)], 50)
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
                           50)
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


def make_trainer(model, data, hp, device, seed, scenario=None):
    from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer

    return RWSADMMTrainer(model, data, hp, batch_size=MAIN["batch"],
                          zone_size=MAIN["zone"], solver="closed_form",
                          scenario=scenario, seed=seed, device=device)


def make_fleet(model, data, hp, device, seed, mode="simultaneous",
               scenario=None):
    from repro_torch.fl.fleet_trainer import FleetRWSADMMTrainer

    return FleetRWSADMMTrainer(
        model, data, hp, n_walkers=FLEET["n_walkers"],
        sync_every=FLEET["sync_every"], fleet_mode=mode,
        batch_size=MAIN["batch"], zone_size=MAIN["zone"],
        solver="closed_form", scenario=scenario, seed=seed, device=device)


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
    rows = scenario_sweep_torch.run(
        n_clients=20, rounds=30, speedup_rounds=150, smoke=True,
        out_dir=os.path.join(HERE, "results", "bench"), device=device)
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
# (PERF.md §4): convergence 100 → 30, Fig. 3/4 80 → 20, the comparison
# 200 → 60, Table 2's rounds a client 8 → 2. The quickstart keeps its 300
# rounds (its hitting time and MB a round are held to the reference's).
PAPER = dict(convergence_rounds=30, hyperparam_rounds=20,
             ablation_rounds=80, comparison_rounds=60,
             table2_clients=(20, 50, 100), table2_rounds_per_client=2,
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
# for the kernel's shapes and the plain hold, the grid itself cut to 60
# (it took 144 s of the smoke at 120).
TABLE1_ROUNDS = 120
TABLE1_GRID_ROUNDS = 60
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
# FedAvg, Ditto and APFL step at lr 0.02, not the reference's 0.05: at
# 0.05 training on this make_cifar_like stand-in collapses in both
# packages (the reference's FedAvg at chance for 3 of 4 seeds by round 10,
# the port's non-finite for 2 of 5; tests/test_torch_cnn_baselines_probe.py).
# Which seeds blow up is a draw, not a port fault: the packages' fp32
# steps part where a max-pool window holds a near-tie (the probe's
# gradient mode), and the full-width round equals the reference's in
# float64 (tests/test_torch_baselines.py).
CNN_BASELINES = dict(rounds=20, walkman_rounds=80, clients_per_round=10,
                     lr=0.02, steady_rounds=10, profiled_rounds=3)
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
            ckpt_rounds=40, check_clients=100_000, check_window=8,
            overhead_clients=2000, overhead_repeats=10, overhead_rounds=32,
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
    its own process (its peak RSS is its own): windows of 8 rounds of
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


def telemetry_phase(make, factory, update: str, off: dict) -> dict:
    """Step a's lazy cell again with a telemetry run attached: equal to
    the unrecorded run (``off``) bit for bit, with the same captured and
    replay counts; the report renders; then the overhead twin at
    n = 2,000 (the median pair's on/off at most ``LAZY["overhead_pct"]``
    %)."""
    import tempfile

    import torch

    from benchmarks import telemetry_overhead_torch
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
    with tempfile.TemporaryDirectory() as td:
        over = telemetry_overhead_torch.measure(
            LAZY["overhead_clients"], rounds=LAZY["overhead_rounds"],
            repeats=LAZY["overhead_repeats"],
            out=os.path.join(td, "rows.json"))
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
# chunked softmax), and those ulps (2^-8 relative) compound over 38
# layers: the H100 reads 1.42-1.64e-2. 5e-2 leaves 3x room over that; it
# fails arithmetic in a coarser type or a fault of order one, but not a
# fault in the ring: with random weights the attention spreads over ~2048
# keys, so a key more, fewer or stale, or a RoPE position one too far,
# read 1.66-1.90e-2 on the H100 (tests/test_torch_teacher_probe.py). The
# fp32 pass holds the ring: there the paths agree to float rounding
# (3.5e-6 on the H100), and those four faults read 2.7e-4 (one key too
# many before the wrap) to 7.8e-3; 1e-4 lies between.
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
                               for a, b in sets], 10)
        warm = device_time_ms([lambda: ops.rglru_scan(a, b)], 10)
        plain = device_time_ms([lambda: rglru_scan_ref(a, b)], 2,
                               graph=False)
        row.update(ms=cold["profiler"], ms_warm=warm["profiler"],
                   graph_ms=cold["graph"], graph_ms_warm=warm["graph"],
                   plain_ms=plain["profiler"],
                   plain_wall_ms=cuda_time_ms(lambda: rglru_scan_ref(a, b),
                                              2, warmup=1),
                   config=dict(zip(("lanes", "steps", "stages",
                                    "smem_bytes"), ops.staged_geometry())))
        # Read a and b, write h, fp32; a multiply and an add per element.
        row.update(lm_kernel_bound(3 * bsz * s * d * 4, 2 * bsz * s * d,
                                   card))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    log(f"kernel rglru_scan {row['shape']}: path {row['path']} (planned "
        f"{row['planned']}) max_abs_err {row['max_abs_err']} bitwise "
        f"{row['bitwise']}"
        + (f" device ms cold {row['ms']:.4f} warm {row['ms_warm']:.4f} "
           f"graph cold {row['graph_ms']:.4f} warm "
           f"{row['graph_ms_warm']:.4f} plain device ms "
           f"{row['plain_ms']:.3f} (wall {row['plain_wall_ms']:.3f}) "
           f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']}, "
           f"{row['bound_rate']}) share {row['share_of_bound']:.3f} "
           f"library none config {row['config']}" if time_it else ""))
    if not row["bitwise"] or row["path"] != row["planned"]:
        raise AssertionError(f"rglru_scan differs from its plain loop or "
                             f"took another path than planned: {row}")
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
    """Both model-zoo kernels at the serving path's shapes (timed first
    rows) and at odd ones: S and D tails, the scan's register-loop path,
    G < 16, short head dims (every remainder of hd mod 32 after the
    tensor-core steps: 0, 8, 16, 24), lengths below S, a row with no
    valid key, windows that leave whole chunks masked."""
    full_len = [2048] * 4
    return {
        "rglru_scan": [
            check_rglru_scan((4, 2040, 4096), device, card, time_it=True),
            check_rglru_scan((2, 1000, 130), device, card, time_it=False),
            check_rglru_scan((3, 129, 100), device, card, time_it=False)],
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
                               "bfloat16", device, card, False)],
    }


def phase_serve(device) -> dict:
    """RecurrentGemma-9B at full width, bf16, seeded random weights:
    prefill 4 × 2040 tokens and 15 greedy decode steps through
    ``launch/serve.py``, the local rings wrapping at decode step 8; then
    the decode logits against a teacher-forced ``apply``, a profile, and
    the generation and check again in fp32."""
    import dataclasses

    import torch

    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.registry import build_model, random_batch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = serve.load_model(LM_ARCH, device=device, seed=SERVE["seed"])
    torch.cuda.synchronize()
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    kinds = [blk.kind for blk in model.layers]
    log(f"serve: {LM_ARCH} {cfg.n_layers} layers ({kinds.count('rglru')} "
        f"rglru, {kinds.count('local')} local), d {cfg.d_model}, vocab "
        f"{cfg.vocab}, {n_params:,} params ({cfg.param_count():,} by "
        f"param_count), {cfg.dtype}, init {time.perf_counter() - t0:.2f} s, "
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
    want_paths = {"rglru_scan": {"staged": n_rglru, "loop": 0}}
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

    # The same path in fp32 (seeded weights of its own): decode and the
    # teacher-forced apply agree to float rounding there, so this pass
    # holds the ring's slots and lengths at full width.
    del prefill, step, tok, cache, fn, model
    torch.cuda.empty_cache()
    model = build_model(dataclasses.replace(cfg, dtype="float32"),
                        device=device).init(SERVE["seed"])
    ids, logits = greedy(model, batch, gen, max_len)
    row["teacher"]["float32"] = teacher = teacher_forced_errors(
        model, batch["tokens"], ids, logits)
    hold_teacher(teacher, "float32", prompt + gen)
    return row


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
    absolute error, the logits' RMS and the share of equal argmaxes."""
    import torch

    t, gen = prompt.shape[1], ids.shape[1]
    with torch.no_grad():
        full = model.apply({"tokens": torch.cat([prompt, ids], 1)})
    forced = full[:, t - 1:t - 1 + gen].clone()
    del full
    per_pos = [_rel_rms(logits[:, j], forced[:, j]) for j in range(gen)]
    return {"rel_rms": per_pos, "rel_rms_max": max(per_pos),
            "max_abs": float((logits - forced).abs().max()),
            "logit_rms": float(forced.pow(2).mean().sqrt()),
            "argmax_agree": float((logits.argmax(-1) == forced.argmax(-1))
                                  .float().mean())}


def hold_teacher(teacher: dict, dtype: str, tokens: int) -> None:
    bound = TEACHER_REL_RMS[dtype]
    log(f"serve {dtype}: decode vs teacher-forced apply over {tokens} "
        f"tokens: relative RMS error per position "
        f"{' '.join(f'{e:.2e}' for e in teacher['rel_rms'])} (bound "
        f"{bound}), max abs {teacher['max_abs']:.4g} on logits of RMS "
        f"{teacher['logit_rms']:.3f}, argmax agreement "
        f"{teacher['argmax_agree']:.3f}")
    if not teacher["rel_rms_max"] <= bound:
        raise AssertionError(f"{dtype} decode disagrees with teacher-forced "
                             f"apply: {teacher['rel_rms']}")


def profile_breakdown(fn, reps: int, label: str) -> dict:
    """``fn`` run ``reps`` times under ``torch.profiler``: device time by
    kernel class, the union of kernel intervals (busy) and the profiled
    wall time, per rep."""
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
    rows = [e for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    by_class: dict[str, float] = {}
    for e in rows:
        name = e.key.lower()
        cls = ("flash_decode" if "flash_decode" in name else
               "rglru_scan" if "rglru_scan" in name else
               "matmul" if any(w in name for w in ("gemm", "gemv", "sm90",
                                                    "cutlass", "xmma",
                                                    "nvjet"))
               else "other")
        by_class[cls] = by_class.get(cls, 0.0) \
            + e.self_device_time_total / reps / 1e3
    spans = [e for e in prof.events() if e.device_type == cuda]
    busy = union_ms([(e.time_range.start, e.time_range.end)
                     for e in spans]) / 1e3 / reps
    top = sorted(((e.self_device_time_total / reps / 1e3, e.key)
                  for e in rows), reverse=True)[:6]
    out = {"wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
           "kernel_ms": sum(by_class.values()), "by_class_ms": by_class,
           "launches": sum(e.count for e in rows) / reps}
    log(f"profile {label}: {wall:.2f} ms wall (profiled), device busy "
        f"{busy:.2f} ms (share {busy / wall:.3f}), {out['launches']:.0f} "
        f"kernel launches, kernel ms by class "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_class.items()))
        + "; top: " + "; ".join(f"{k[:60]} {v:.3f}" for v, k in top))
    return out


# ---------------------------------------------------------------------------
_RW_SOURCE = "src/repro_torch/kernels/rwsadmm_update/csrc/zone_update.cu"
_TF_SOURCE = "src/repro_torch/kernels/threefry/csrc/threefry.cu"
SOURCE = {"zone_update": _RW_SOURCE, "multizone_update": _RW_SOURCE,
          "fused_update": _RW_SOURCE,
          "rglru_scan": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
          "flash_decode":
              "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
          "threefry_draws": _TF_SOURCE, "threefry_bits": _TF_SOURCE}
REPLACES = {"zone_update": "src/repro/kernels/rwsadmm_update/kernel.py:176",
            "multizone_update":
                "src/repro/kernels/rwsadmm_update/kernel.py:147",
            "fused_update": "src/repro/kernels/rwsadmm_update/kernel.py:51",
            "rglru_scan": "src/repro/kernels/rglru_scan/kernel.py:49",
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
        if kernel in ("rglru_scan", "flash_decode", *THREEFRY):
            row["ptxas"] = {e: v for e, v in ptxas.items()
                            if e.startswith(kernel)}
        if "sign_flips" in timed:
            row["sign_flips"] = sum(r["sign_flips"] for r in checks)
        kernels.append(row)
    log(json.dumps({"kernels": kernels}))
    for label, summary in paths.items():
        log(json.dumps({label: summary}, default=str))
    log(f"phase seconds: {PHASE_SECONDS}")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
