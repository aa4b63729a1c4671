"""The Table 1 twin's closed-form RWSADMM rows (``rwsadmm_cf``: β = 10,
zone 8, ``scan_fused``) against the reference's at the same config, on
the CPU.

Both packages walk the same graph and zones from one seed, start from the
same weights and draw the same minibatches (the port's threefry is the
reference's), so only the last bits of their gradients differ. On the MLR
cells those bits never change a prediction: over seeds 0-4 each seed's
final accuracies agree within 6e-8 (the accuracy's own rounding), and
seed 0 is held within ``BAND`` = 1e-5 there. The MLP cells are chaotic in
fp32: the reference started from its initial state scaled by 1 ± 1e-7
(one ulp) ends 0.005 (seed 0) and 0.058 (seed 1) apart on mnist_like, the
port 0.12 and 0.15, and the packages' gaps there (0.092 and 0.044) lie
inside those spreads; on synthetic the port's own ±1-ulp spread at seed 0
is 0.038. Those cells keep the band set when the packages drew from
different generators, 0.2 (the reference's seed-to-seed spread over seeds
0-4 at 120 rounds reaches 0.169); the float64 run tier
(``test_torch_run_float64*.py``) holds the round itself seed for seed.
The spreads are this file's script mode (``--algos`` runs other rows of
the twin, e.g. ``perfedavg``; ``--perturb EPS`` scales both packages'
initial state by the fp32 number nearest 1 + EPS):

    PYTHONPATH=src:tests:. JAX_PLATFORMS=cpu python \
        tests/test_torch_table1.py --seeds 0 1 2 3 4 [--perturb 1e-7]
"""
from __future__ import annotations

import argparse
import json

import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROUNDS = 120
#: each cell's final accuracy gap at seed 0 (see above)
BAND = {"mnist_like/mlr": 1e-5, "synthetic/mlr": 1e-5,
        "mnist_like/mlp": 0.2, "synthetic/mlp": 0.2}
CELLS = [("mnist_like", "mlr"), ("mnist_like", "mlp"), ("synthetic", "mlr"),
         ("synthetic", "mlp")]


def final_acc(cell, seeds, rounds=ROUNDS, algo="rwsadmm_cf",
              perturb=0.0) -> dict:
    """Final personalized accuracy of ``algo`` on one Table 1 cell, per
    seed, in each package; with ``perturb`` both start from their initial
    state scaled by the fp32 number nearest 1 + ``perturb``."""
    from benchmarks import common, table1_torch
    from repro.fl.simulation import run_simulation as r_run
    from repro.models.small import get_model as r_model
    from repro_torch.fl.simulation import run_simulation
    from repro_torch.models.small import get_model
    from test_torch_cnn_baselines_probe import perturb_init

    ds, name = cell
    if ds == "mnist_like":
        r_data, shape = common.mnist_like_fed(n_clients=10, n_samples=2000)
    else:
        r_data, shape = common.synthetic_fed(n_clients=20)
    data = table1_torch.datasets("cpu")[ds][0]
    out = {"reference": [], "port": []}
    for seed in seeds:
        ref = common.make_trainer(algo, r_model(name, shape), r_data)
        perturb_init(ref, perturb, "reference")
        out["reference"].append(r_run(ref, rounds=rounds, eval_every=rounds,
                                      seed=seed).final["acc"])
        port = table1_torch.make_trainer(algo, get_model(name, shape), data,
                                         device="cpu")
        perturb_init(port, perturb, "port")
        out["port"].append(run_simulation(
            port, rounds=rounds, eval_every=rounds, seed=seed,
            engine=table1_torch.ENGINE.get(algo, "eager")).final["acc"])
    return out


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_closed_form_rows_match_reference(cell):
    acc = final_acc(cell, [0])
    assert abs(acc["port"][0] - acc["reference"][0]) <= \
        BAND["/".join(cell)], acc


def test_script_runs_other_algos_perturbed(capsys):
    """The script mode's ``--algos``, ``--cells`` and ``--perturb`` at two
    rounds: one line per (algorithm, cell), both packages per seed."""
    main(["--rounds", "2", "--seeds", "0", "1", "--cells", "synthetic/mlr",
          "--algos", "perfedavg", "--perturb", "1e-7"])
    (row,) = [json.loads(line) for line in
              capsys.readouterr().out.splitlines()]
    assert (row["algo"], row["cell"], row["perturb"], row["seeds"]) == (
        "perfedavg", "synthetic/mlr", 1e-7, [0, 1])
    for package in ("reference", "port"):
        assert len(row[package]) == 2
        assert all(0.0 <= a <= 1.0 for a in row[package])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--algos", nargs="+", default=["rwsadmm_cf"],
                    help="Table 1 twin's algorithms (benchmarks/common.py)")
    ap.add_argument("--cells", nargs="+", default=["/".join(c) for c in CELLS],
                    choices=["/".join(c) for c in CELLS])
    ap.add_argument("--perturb", type=float, default=0.0, metavar="EPS",
                    help="scale both packages' initial state by the fp32 "
                    "number nearest 1 + EPS")
    args = ap.parse_args(argv)
    for algo in args.algos:
        for cell in args.cells:
            acc = final_acc(tuple(cell.split("/")), args.seeds, args.rounds,
                            algo, args.perturb)
            print(json.dumps({"algo": algo, "cell": cell,
                              "perturb": args.perturb, "seeds": args.seeds,
                              **acc, **{f"{k}_spread": max(v) - min(v)
                                        for k, v in acc.items()}}),
                  flush=True)


if __name__ == "__main__":
    main()
