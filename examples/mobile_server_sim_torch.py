"""Mobile-server simulation on the PyTorch port's control plane (the twin
of ``examples/mobile_server_sim.py``, importing only ``repro_torch``):
RWSADMM's control plane in isolation, driven by the scenario subsystem
(``src/repro_torch/scenarios/``). Host-side numpy only: it needs no card.

For each registered scenario this shows the mobility process (smooth
motion vs i.i.d. redraws), the wireless link layer (per-link success
probabilities, stochastic dropouts), client churn (duty-cycled
availability), the non-homogeneous Markov chain (Eq. 2) with its
mixing-time certificate (Eq. 6), and the wireless communication ledger
— bytes, latency, and energy per round instead of bytes alone.

Run:  PYTHONPATH=src python examples/mobile_server_sim_torch.py [scenario ...]
"""
import sys

sys.path.insert(0, "src")

import numpy as np

from repro_torch.core.markov import (
    RandomWalkServer,
    degree_transition_matrix,
    mixing_time,
    p_max_envelope,
    stationary_distribution,
    verify_assumption_3_1,
)
from repro_torch.scenarios import Scenario, available_scenarios

MODEL_BYTES = 1_200_000   # MLP-sized walking token
ROUNDS = 500


def simulate(name: str, n: int = 20, rounds: int = ROUNDS) -> None:
    print(f"\n=== scenario: {name} ===")
    scn = Scenario(n, name, seed=0)
    walker = RandomWalkServer(seed=1)
    walker.reset(scn.current())

    total_lat = total_en = comm_mb = 0.0
    offline_rounds = 0
    ps = []
    for k in range(rounds):
        graph = scn.step() if k else scn.current()
        ps.append(degree_transition_matrix(graph))
        i_k = walker.step(graph) if k else walker.position
        zone = graph.neighborhood(i_k)
        avail = scn.availability()
        if avail is not None:
            zone = zone[avail[zone] | (zone == i_k)]
            offline_rounds += int((~avail).sum() > 0)
        comm_mb += MODEL_BYTES * (1 + len(zone)) / 1e6
        lat, en = scn.price_round(
            graph, int(i_k), zone.astype(np.int32),
            np.ones(len(zone), np.float32), MODEL_BYTES)
        total_lat += lat
        total_en += en
        if k in (0, 9, 10, rounds - 1):
            drop = ""
            if scn.link is not None:
                p = scn.link.link_matrix(graph)
                live = p[p > 0]
                drop = (f", mean link p={live.mean():.2f}"
                        if live.size else "")
            print(f"round {k:3d}: server @ client {i_k:2d}, "
                  f"|zone|={len(zone)}, edges={graph.n_edges}{drop}")

    print(f"hitting time T (all clients visited): {walker.hitting_time()}")
    freq = walker.visit_counts / walker.visit_counts.sum()
    pi = stationary_distribution(ps[-1])
    print(f"visit-frequency vs stationary π: "
          f"max dev {np.abs(freq - pi).max():.4f}")
    rep = verify_assumption_3_1(ps[-1], delta=0.5)
    print(f"Assumption 3.1: tau(0.5)={rep['tau']}, "
          f"sigma={rep['sigma']:.3f}, holds={rep['holds']}")
    env = p_max_envelope(ps)
    env = env / np.maximum(env.sum(1, keepdims=True), 1e-12)
    print(f"P_max envelope (Eq. 5): tau bound = {mixing_time(env)}")
    if offline_rounds:
        print(f"churn: clients were offline in {offline_rounds}/{rounds} "
              f"rounds")
    print(f"comm ledger over {rounds} rounds: {comm_mb:.0f} MB "
          f"({comm_mb / rounds:.1f} MB/round — O(1) in n), "
          f"latency {total_lat:.1f} s, energy {total_en:.1f} J")


def main(names=None, rounds: int = ROUNDS) -> None:
    names = names or sys.argv[1:] or available_scenarios()
    for name in names:
        simulate(name, rounds=rounds)
    print(f"\nFedAvg reference: 10 clients/round would move "
          f"{2 * 10 * MODEL_BYTES / 1e6:.1f} MB/round via the base "
          f"station, O(m) in cohort size.")


if __name__ == "__main__":
    main()
