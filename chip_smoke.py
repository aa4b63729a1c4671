"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero):

1. device — needs CUDA; prints the card's name and power limit
   (``nvidia-smi``) and turns TF32 off for matmuls and convolutions.
2. build — builds the main path's kernel from ``src/repro_torch`` with
   ``nvcc``.
3. kernels — holds each kernel against its plain PyTorch version on the
   card at the main path's shapes, and times both beside the bound.
4. main path — single-walker RWSADMM through ``run_simulation`` on the
   paper's CIFAR-10 CNN at full width (P = 1,068,266), n = 100 clients,
   zone 8, batch 20, ``closed_form`` + ``engine="scan_fused"``; checks
   finite losses, the accuracy report and that the zone kernel ran once
   per round; then ``eager`` from the same seed and weights must agree
   with ``scan_fused``.

Ends with a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 data-sheet peaks (dense): memory bandwidth by part, fp32 non-tensor.
HBM_BYTES_PER_S = {"pcie": 2.0e12, "sxm": 3.35e12}
FP32_FLOP_PER_S = 67e12

ENGINES = ("eager", "scan", "scan_fused")
MAIN = dict(n_samples=12_000, n_clients=100, zone=8, batch=20, rounds=50,
            eager_rounds=5, seed=0)
# Eager vs scan_fused after a few rounds: the plain and kernel updates
# agree to the last bit or so per round, and those ulps feed the next
# rounds' gradients (cuDNN's backward is not bitwise reproducible), so
# the states are compared at 1e-4 absolute, not bit for bit.
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


# ---------------------------------------------------------------------------
def phase_build() -> Path:
    """Build the main path's one kernel source with nvcc."""
    from repro_torch.kernels.rwsadmm_update import ops as zone_ops

    t0 = time.perf_counter()
    lib = zone_ops.build()
    log(f"build: 1 kernel in {time.perf_counter() - t0:.2f} s ({lib.name})")
    return lib


def zone_inputs(zone: int, n: int, live: int, seed: int, device):
    """Random zone-update inputs on the card: slot 0 has x = y (warm
    init, sgn(0)), slots ≥ ``live`` are padding."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    x, z, g = (torch.randn(zone, n, generator=gen, device=device)
               for _ in range(3))
    y = torch.randn(n, generator=gen, device=device)
    z.mul_(0.01)
    x[0] = y
    mask = torch.zeros(zone, device=device)
    mask[:live] = 1.0
    kappa = torch.tensor([0.001], device=device)
    return x, z, y, g, mask, kappa


def check_zone_kernel(zone: int, n: int, live: int, hp, device, name: str,
                      time_it: bool) -> dict:
    import torch

    from repro_torch.kernels.rwsadmm_update import ops
    from repro_torch.kernels.rwsadmm_update.ref import zone_fused_update_ref

    x, z, y, g, mask, kappa = zone_inputs(zone, n, live, seed=zone * 7 + n,
                                          device=device)
    kw = dict(beta=hp.beta, eps_half=hp.eps_half, n_total=100.0)
    xk, zk, yk = ops.zone_fused_update(x, z, y, g, mask, kappa, **kw)
    torch.cuda.synchronize()
    xp, zp, yp = zone_fused_update_ref(x, z, y, g, mask, kappa, **kw)
    err = {k: float((a - b).abs().max()) for k, a, b in
           (("x", xk, xp), ("z", zk, zp), ("y", yk, yp))}
    live_rows = mask > 0
    flips = int((torch.sign(y - xk[live_rows])
                 != torch.sign(y - xp[live_rows])).any(dim=0).sum())
    pad_exact = bool(torch.equal(xk[~live_rows], x[~live_rows])
                     and torch.equal(zk[~live_rows], z[~live_rows]))
    ok_xz = all(torch.allclose(a, b, atol=KERNEL_TOL, rtol=KERNEL_TOL)
                for a, b in ((xk, xp), (zk, zp)))
    if flips:
        flip_pos = (torch.sign(y - xk[live_rows])
                    != torch.sign(y - xp[live_rows])).any(dim=0)
        ok_y = torch.allclose(yk[~flip_pos], yp[~flip_pos],
                              atol=KERNEL_TOL, rtol=KERNEL_TOL)
    else:
        ok_y = torch.allclose(yk, yp, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    row = {"shape": f"Z={zone} N={n} live={live}", "err": err,
           "sign_flips": flips, "padded_slots_exact": pad_exact}
    if time_it:
        launches = ops.zone_fused_update.launches
        row["ms"] = cuda_time_ms(
            lambda: ops.zone_fused_update(x, z, y, g, mask, kappa, **kw), 50)
        row["plain_ms"] = cuda_time_ms(
            lambda: zone_fused_update_ref(x, z, y, g, mask, kappa, **kw), 10)
        ops.zone_fused_update.launches = launches   # timing is not the path
        # Read x, z (every slot), g (live slots only: a padded slot's
        # output is its input) and y; write x⁺, z⁺ and y⁺. All slots
        # live: (5Z + 2)·N·4 bytes.
        bytes_moved = (4 * zone + live + 2) * n * 4
        flops = 34 * zone * n + 2 * n   # elementwise fp32 ops per round
        rate, rate_src = hbm_rate(name)
        bytes_ms = bytes_moved / rate * 1e3
        ops_ms = flops / FP32_FLOP_PER_S * 1e3
        row.update(bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bound_rate=rate_src, bytes=bytes_moved)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    log(f"kernel zone_update {row['shape']}: max_abs_err {err} sign_flips "
        f"{flips} padded_exact {pad_exact}"
        + (f" ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} bound_ms "
           f"{row['bound_ms']:.4f} ({row['bound_by']}, {row['bound_rate']}) "
           f"share {row['share_of_bound']:.3f}" if time_it else ""))
    if not (ok_xz and ok_y and pad_exact):
        raise AssertionError(f"zone_update disagrees with its plain version "
                             f"at {row['shape']}: {row}")
    return row


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


def make_trainer(model, data, hp, device, seed):
    from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer

    return RWSADMMTrainer(model, data, hp, batch_size=MAIN["batch"],
                          zone_size=MAIN["zone"], solver="closed_form",
                          seed=seed, device=device)


def phase_main_path(device) -> dict:
    import torch

    from repro_torch.fl.base import validate_round_metrics
    from repro_torch.fl.simulation import run_simulation
    from repro_torch.kernels.rwsadmm_update import ops

    seed = MAIN["seed"]
    model, data, hp = build_main_path(device, seed)
    trainer = make_trainer(model, data, hp, device, seed)
    log(f"model: cnn (32, 32, 3) P = {trainer.layout.size:,} "
        f"({trainer.params_bytes() / 1e6:.2f} MB fp32)")

    # Warm-up (cuDNN plans, allocator) on a throwaway trainer.
    run_simulation(make_trainer(model, data, hp, device, seed + 1),
                   rounds=3, eval_every=3, seed=seed + 1,
                   engine="scan_fused")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    rounds = MAIN["rounds"]
    ops.zone_fused_update.launches = 0
    res = run_simulation(trainer, rounds=rounds, eval_every=rounds,
                         seed=seed, engine="scan_fused")
    torch.cuda.synchronize()
    launches = ops.zone_fused_update.launches
    peak = torch.cuda.max_memory_allocated()

    validate_round_metrics(res.round_metrics)
    losses = [m["train_loss"] for m in res.round_metrics]
    if len(losses) != rounds or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite or missing losses: {losses}")
    acc = res.final.get("acc_personalized")
    if acc is None or not math.isfinite(acc):
        raise AssertionError(f"no personalized accuracy: {res.final}")
    if launches != rounds:
        raise AssertionError(f"zone kernel launched {launches} times in "
                             f"{rounds} rounds")
    log(f"main path: {rounds} rounds scan_fused in {res.wall_time_s:.3f} s "
        f"= {rounds / res.wall_time_s:.2f} rounds/s (one eval included), "
        f"peak allocated {peak / 2**30:.3f} GiB, zone kernel launches "
        f"{launches}, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"acc_personalized {acc:.4f} ± "
        f"{res.final['acc_personalized_std']:.4f}, acc_global "
        f"{res.final['acc_global']:.4f}")
    steady = time_steady_rounds(trainer)
    compare_eager(model, data, hp, device)
    return {"launches": launches, "rounds_per_s": rounds / res.wall_time_s,
            "peak_gib": peak / 2**30, "acc_personalized": acc, **steady}


def time_steady_rounds(trainer) -> dict:
    """Steady ms/round of each engine on a warm trainer (no schedule, no
    eval inside the timed region; eager plans its rounds inside), the
    evaluation's own time, and a profile of a few scan_fused rounds
    (device busy share, top kernels)."""
    import numpy as np
    import torch

    from repro_torch.kernels.rwsadmm_update import ops

    launches = ops.zone_fused_update.launches
    times: dict[str, list[float]] = {e: [] for e in ENGINES}
    n = 30
    for rep in range(3):          # engines in turn, so drift hits all alike
        for engine in ENGINES:
            rng = np.random.default_rng(rep)
            state = trainer.init_state(0)
            if engine == "eager":
                trainer.round(state, 0, rng)        # plan + warm round 0
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

    rounds = 10
    sched = trainer.schedule(rounds, np.random.default_rng(2), start_round=1)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        trainer.run_chunk(state, sched, engine="scan_fused")
        torch.cuda.synchronize()
    ops.zone_fused_update.launches = launches
    # Kernel rows only (op rows would count the same device time twice).
    kernels = {e.key: e.self_device_time_total / rounds / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0}
    busy_ms = sum(kernels.values())
    out["device_ms_per_round"] = busy_ms
    # Busy share against the unprofiled steady round time above.
    out["busy_share"] = busy_ms / out["scan_fused_round_ms"]
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log("steady ms/round (median of 3 runs of 30 rounds; runs): " + ", ".join(
        f"{e} {out[e + '_round_ms']:.3f} "
        f"({' '.join(f'{t:.3f}' for t in out[e + '_round_ms_runs'])})"
        for e in ENGINES)
        + f"; evaluate over {trainer.n_clients} clients {out['eval_s']:.3f} s")
    log(f"profile: scan_fused kernels take {busy_ms:.3f} device ms per "
        f"round over {len(kernels)} kernel names, busy share "
        f"{out['busy_share']:.3f} of the {out['scan_fused_round_ms']:.3f} ms "
        f"steady round; top (ms/round): "
        + "; ".join(f"{k[:70]} {v:.4f}" for k, v in top))
    return out


def compare_eager(model, data, hp, device) -> None:
    """A few eager rounds (plain update) against scan_fused (kernel) from
    the same seed and weights."""
    import numpy as np
    import torch

    from repro_torch.kernels.rwsadmm_update import ops

    k = MAIN["eager_rounds"]
    seed = MAIN["seed"]
    eager = make_trainer(model, data, hp, device, seed)
    rng = np.random.default_rng(seed)
    s_e = eager.init_state(seed)
    for r in range(k):
        s_e, _ = eager.round(s_e, r, rng)
    fused = make_trainer(model, data, hp, device, seed)
    rng = np.random.default_rng(seed)
    s_f = fused.init_state(seed)
    launches = ops.zone_fused_update.launches
    s_f, _ = fused.run_chunk(s_f, fused.schedule(k, rng), "scan_fused")
    ops.zone_fused_update.launches = launches
    torch.cuda.synchronize()
    diff = {"x": float((s_e.clients.x - s_f.clients.x).abs().max()),
            "z": float((s_e.clients.z - s_f.clients.z).abs().max()),
            "y": float((s_e.server.y - s_f.server.y).abs().max()),
            "kappa": float((s_e.server.kappa - s_f.server.kappa).abs())}
    log(f"eager vs scan_fused after {k} rounds: max_abs_diff {diff} "
        f"(atol {EAGER_ATOL})")
    if not all(v <= EAGER_ATOL for v in diff.values()):
        raise AssertionError(f"eager and scan_fused disagree: {diff}")


# ---------------------------------------------------------------------------
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels.rwsadmm_update import ops

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name} | {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | TF32 off")

    phase_build()

    from repro_torch.core.rwsadmm import RWSADMMHparams

    hp = RWSADMMHparams(beta=100.0)   # the main path's (phase_main_path)
    p_cnn = 1_068_266
    main_row = check_zone_kernel(MAIN["zone"], p_cnn, MAIN["zone"], hp,
                                 device, name, time_it=True)
    others = [check_zone_kernel(MAIN["zone"], p_cnn, 6, hp, device, name,
                                time_it=False),
              check_zone_kernel(3, 100_003, 2, hp, device, name,
                                time_it=False)]

    main = phase_main_path(device)

    kernels = [{
        "name": "zone_update",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwsadmm_update/csrc/zone_update.cu",
        "replaces": "src/repro/kernels/rwsadmm_update/kernel.py:176",
        "launches": main["launches"],
        "max_abs_err": max(max(r["err"].values())
                           for r in [main_row] + others),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "share_of_bound": main_row["share_of_bound"],
        "sign_flips": sum(r["sign_flips"] for r in [main_row] + others),
        "shape": main_row["shape"],
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"main_path": main}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
