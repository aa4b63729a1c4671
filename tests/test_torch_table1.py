"""The Table 1 twin's closed-form RWSADMM rows (``rwsadmm_cf``: β = 10,
zone 8, ``scan_fused``) against the reference's at the same config, on
the CPU.

Both packages walk the same graph and zones from one seed but draw their
minibatches from different generators (threefry against torch's), so
their final accuracies are two samples of one seed-to-seed distribution.
The reference's own final accuracy over seeds 0-4 at 120 rounds spreads
by up to 0.169 (mnist_like MLP; MLR 0.148, synthetic 0.049 and 0.085), so
seed 0 of the two packages is held within ``BAND`` = 0.2. The spread is
this file's script mode:

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_table1.py \\
        --seeds 0 1 2 3 4
"""
from __future__ import annotations

import argparse
import json

import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROUNDS, BAND = 120, 0.2
CELLS = [("mnist_like", "mlr"), ("mnist_like", "mlp"), ("synthetic", "mlr"),
         ("synthetic", "mlp")]


def final_acc(cell, seeds, rounds=ROUNDS) -> dict:
    """Final personalized accuracy of ``rwsadmm_cf`` on one Table 1 cell,
    per seed, in each package."""
    from benchmarks import common, table1_torch
    from repro.fl.simulation import run_simulation as r_run
    from repro.models.small import get_model as r_model
    from repro_torch.fl.simulation import run_simulation
    from repro_torch.models.small import get_model

    ds, name = cell
    if ds == "mnist_like":
        r_data, shape = common.mnist_like_fed(n_clients=10, n_samples=2000)
    else:
        r_data, shape = common.synthetic_fed(n_clients=20)
    data = table1_torch.datasets("cpu")[ds][0]
    out = {"reference": [], "port": []}
    for seed in seeds:
        ref = common.make_trainer("rwsadmm_cf", r_model(name, shape), r_data)
        out["reference"].append(r_run(ref, rounds=rounds, eval_every=rounds,
                                      seed=seed).final["acc"])
        port = table1_torch.make_trainer("rwsadmm_cf", get_model(name, shape),
                                         data, device="cpu")
        out["port"].append(run_simulation(
            port, rounds=rounds, eval_every=rounds, seed=seed,
            engine=table1_torch.ENGINE["rwsadmm_cf"]).final["acc"])
    return out


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_closed_form_rows_match_reference(cell):
    acc = final_acc(cell, [0])
    assert abs(acc["port"][0] - acc["reference"][0]) <= BAND, acc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args(argv)
    for cell in CELLS:
        acc = final_acc(cell, args.seeds, args.rounds)
        print(json.dumps({"cell": "/".join(cell), "seeds": args.seeds,
                          **acc, **{f"{k}_spread": max(v) - min(v)
                                    for k, v in acc.items()}}), flush=True)


if __name__ == "__main__":
    main()
