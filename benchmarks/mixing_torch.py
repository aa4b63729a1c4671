"""Assumption 3.1 / Eq. 6 on the PyTorch port (the twin of
``benchmarks/mixing.py``, importing only ``repro_torch``): the mixing
time τ(δ), σ(P), λ₂ and App. D.2's eigenvalue requirement over five
topologies, then the walk-policy sweep: hitting time, staleness and
accuracy against the uniform Metropolis walk for every
``markov.WALK_POLICIES`` entry on the paper's pathological split.

    PYTHONPATH=src python -m benchmarks.mixing_torch [--smoke] [--device cpu]

The mixing report is host numpy. The sweep trains on ``cuda`` unless
``--device cpu`` and writes its rows, stamped with the torch and CUDA
versions, the device's name and power limit, into
``BENCH_torch_scaling.json`` (``--out`` to write elsewhere). It asserts
the reference's acceptance property: some biased policy beats uniform
Metropolis on mean hitting time and on mean worst staleness.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import graph as G
from repro_torch.core import markov as M
from repro_torch.core.rwsadmm import RWSADMMHparams
from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer
from repro_torch.fl.simulation import run_simulation
from repro_torch.models.small import get_model

from .scan_scaling_torch import OUT, emit, stamp, write_rows
from .table1_torch import mnist_like_fed


def run(*, smoke: bool = False, device=None, out: str = OUT) -> None:
    mixing_report()
    policy_sweep(smoke=smoke, device=device, out=out)


def mixing_report() -> list[dict]:
    """τ(0.5), σ, λ₂, whether Eq. 3 holds at τ, and App. D.2's
    λ₂ < 1 − 1/m^(2/3) (m edges) on the degree chain of each graph."""
    rng = np.random.default_rng(0)
    tests = [
        ("geo_n20_deg5", G.random_geometric_graph(20, 5, rng)),
        ("geo_n100_deg5", G.random_geometric_graph(100, 5, rng)),
        ("geo_n100_deg20", G.random_geometric_graph(100, 20, rng)),
        ("line_n20", G.line_graph(20)),
        ("complete_n20", G.complete_graph(20)),
    ]
    rows = []
    for name, g in tests:
        p = M.degree_transition_matrix(g)
        rep = M.verify_assumption_3_1(p, delta=0.5)
        m = g.n_edges
        eig_req = rep["lambda2"] < 1 - 1 / m ** (2 / 3)
        emit(f"mixing/{name}", 0.0,
             f"tau={rep['tau']} sigma={rep['sigma']:.4f} "
             f"lambda2={rep['lambda2']:.4f} holds={rep['holds']} "
             f"appD2={bool(eig_req)}")
        rows.append({"graph": name, **rep, "appD2": bool(eig_req)})
    return rows


def policy_sweep(*, rounds: int = 40, n_clients: int = 12,
                 walk_bias: float = 0.5, seeds: tuple = (0, 1, 2),
                 smoke: bool = False, device=None,
                 out: str = OUT) -> list[dict]:
    """Seed-averaged runs (``scan``) per walk policy: hitting time
    (rounds to full coverage, ``rounds + 1`` if never), the worst and
    final median staleness, personalized accuracy and its gap to uniform
    Metropolis. γ = 0.5 keeps the importance weights' spread small."""
    device = resolve_device(device)
    if smoke:
        seeds = seeds[:2]
    data, shape = mnist_like_fed(n_clients, n_samples=1200 if smoke else 3000,
                                 seed=0, device=device)
    model = get_model("mlr", shape)

    def simulate(policy: str, seed: int):
        tr = RWSADMMTrainer(
            model, data, RWSADMMHparams(beta=10.0, kappa=0.001, epsilon=1e-5),
            zone_size=4, batch_size=20, solver="closed_form",
            walk_policy=policy, walk_bias=walk_bias, seed=seed, device=device)
        return tr, run_simulation(tr, rounds=rounds, eval_every=rounds,
                                  seed=seed, engine="scan")

    # One untimed run first, so that the process's one-time costs (kernel
    # builds and loads, library handles) fall on no policy's time.
    simulate(M.WALK_POLICIES[0], seeds[0])
    results: dict[str, dict] = {}
    for policy in M.WALK_POLICIES:
        hits, smaxs, p50s, accs = [], [], [], []
        t0 = time.perf_counter()
        for seed in seeds:
            tr, res = simulate(policy, seed)
            hit = tr.walker.hitting_time()
            hits.append(hit if hit is not None else rounds + 1)
            smaxs.append(max(m["staleness_max"] for m in res.round_metrics))
            p50s.append(res.round_metrics[-1]["staleness_p50"])
            accs.append(res.history[-1]["acc_personalized"])
        us = (time.perf_counter() - t0) / (rounds * len(seeds)) * 1e6
        r = results[policy] = {
            "hitting_time": float(np.mean(hits)),
            "staleness_max": float(np.mean(smaxs)),
            "staleness_p50": float(np.mean(p50s)),
            "acc": float(np.mean(accs)), "us": us}
        emit(f"mixing/policy_{policy}", us,
             f"hit={r['hitting_time']:.1f} "
             f"stale_max={r['staleness_max']:.1f} "
             f"stale_p50={r['staleness_p50']:.1f} acc={r['acc']:.4f}")

    acc_uniform = results["metropolis"]["acc"]
    rows = []
    for policy, r in results.items():
        r["acc_vs_uniform"] = round(r["acc"] - acc_uniform, 4)
        rows.append({"name": f"walk_policy/{policy}", "n": n_clients,
                     "engine": "scan", "us_per_round": r.pop("us"),
                     "rounds": rounds, "seeds": len(seeds),
                     "bias_gamma": walk_bias, **r, **stamp(device)})
    write_rows(rows, out)

    # Acceptance: some biased policy dominates uniform Metropolis on
    # both coverage speed and worst service gap.
    uni = results["metropolis"]
    winners = [p for p in sorted(M.BIASED_POLICIES)
               if results[p]["hitting_time"] < uni["hitting_time"]
               and results[p]["staleness_max"] < uni["staleness_max"]]
    emit("mixing/policy_acceptance", 0.0,
         f"winners={winners} uniform_hit={uni['hitting_time']} "
         f"uniform_stale_max={uni['staleness_max']}")
    if not winners:
        raise AssertionError(
            "no biased policy beat uniform Metropolis on hitting time "
            f"AND staleness_max: {results}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the policy sweep alone, at the CI budget")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    if args.smoke:
        policy_sweep(smoke=True, device=args.device, out=args.out)
    else:
        run(device=args.device, out=args.out)
