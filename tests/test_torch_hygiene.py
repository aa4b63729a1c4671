"""The port stands alone: no JAX and nothing of ``repro`` in its import
graph, and its entry points default to the GPU instead of quietly running
on the CPU. The Table 1, quickstart and paper-script twins run end to end
on the CPU at a few rounds."""
import ast
import importlib.util
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.data import build_federated, make_image_dataset, \
    pathological_split
from repro_torch.fl.base import to_device_data
from repro_torch.fl.rwsadmm_trainer import RWSADMMTrainer
from repro_torch.models.small import MLR
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TWINS = {"table1": ROOT / "benchmarks" / "table1_torch.py",
         "quickstart": ROOT / "examples" / "quickstart_torch.py"}
#: the scenario slice's entry points (run on the CPU in
#: tests/test_torch_scenarios.py)
SCENARIO_TWINS = [ROOT / "benchmarks" / "scenario_sweep_torch.py",
                  ROOT / "benchmarks" / "comm_cost_torch.py",
                  ROOT / "benchmarks" / "scan_scaling_torch.py",
                  ROOT / "examples" / "mobile_server_sim_torch.py"]
#: the lazy-plane slice's benchmark twin (its --lazy section lives in
#: scan_scaling_torch.py)
TELEMETRY_TWINS = [ROOT / "benchmarks" / "telemetry_overhead_torch.py"]
#: the model zoo's examples (run on the CPU in tests/test_torch_zoo.py and
#: tests/test_torch_train_step.py)
ZOO_TWINS = [ROOT / "examples" / "serve_personalized_torch.py",
             ROOT / "examples" / "federated_lm_torch.py"]
#: the paper's other result scripts (Fig. 2, Table 2, Fig. 3/4, mixing,
#: ablations, the personalization comparison)
PAPER_TWINS = {name: ROOT / sub / f"{name}_torch.py" for sub, name in (
    ("benchmarks", "convergence"), ("benchmarks", "table2_scaling"),
    ("benchmarks", "hyperparam"), ("benchmarks", "mixing"),
    ("benchmarks", "ablations"), ("examples", "personalization_comparison"))}
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "kernel_ab.py",
    *TWINS.values(), *SCENARIO_TWINS, *PAPER_TWINS.values(),
    *TELEMETRY_TWINS, *ZOO_TWINS]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_imports_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.convert\n"
        "import repro_torch.fl.rwsadmm_trainer, repro_torch.fl.simulation\n"
        "import repro_torch.kernels.rwsadmm_update.ops\n"
        "import repro_torch.kernels.flash_decode.ops\n"
        "import repro_torch.kernels.rglru_scan.ops\n"
        "import repro_torch.launch.serve, repro_torch.models.registry\n"
        "import repro_torch.baselines\n"
        "import benchmarks.table1_torch, examples.quickstart_torch\n"
        "import repro_torch.scenarios, benchmarks.scenario_sweep_torch\n"
        "import benchmarks.comm_cost_torch, benchmarks.scan_scaling_torch\n"
        "import examples.mobile_server_sim_torch\n"
        "import benchmarks.convergence_torch, benchmarks.hyperparam_torch\n"
        "import benchmarks.table2_scaling_torch, benchmarks.mixing_torch\n"
        "import benchmarks.ablations_torch\n"
        "import examples.personalization_comparison_torch\n"
        "import repro_torch.fl.client_store, repro_torch.checkpoint\n"
        "import repro_torch.core.privacy, repro_torch.telemetry\n"
        "import repro_torch.telemetry.report, repro_torch.telemetry.smoke\n"
        "import benchmarks.telemetry_overhead_torch\n"
        "import repro_torch.launch.steps, examples.federated_lm_torch\n"
        "import repro_torch.models.moe\n"
        "import repro_torch.launch.train, repro_torch.optim\n"
        "import examples.serve_personalized_torch\n"
        "import repro_torch.analysis, repro_torch.analysis.check\n"
        "import repro_torch.analysis.registry\n"
        "import repro_torch.analysis.capture_budget\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.roofline_report\n"
        "import repro_torch.launch.perf_iterations\n"
        "import repro_torch.launch.fill_experiments\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_default_device_is_cuda():
    imgs, labels = make_image_dataset(80, shape=(4, 4, 1), seed=0)
    fed = build_federated(imgs, labels, pathological_split(labels, 4))
    data = to_device_data(fed, "cpu")
    if torch.cuda.is_available():
        assert repro_torch.resolve_device().type == "cuda"
        with pytest.raises(ValueError, match="data lives on"):
            RWSADMMTrainer(MLR((4, 4, 1)), data)
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_device_data(fed)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RWSADMMTrainer(MLR((4, 4, 1)), data)
    assert np.isfinite(RWSADMMTrainer(MLR((4, 4, 1)), data,
                                      device="cpu").params_bytes())


def _load(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("twin", sorted(TWINS))
def test_twin_runs_on_cpu(twin, tmp_path, capsys):
    """Each twin end to end at 2 rounds with ``device="cpu"``: finite
    results, and the lines the reference's entry point prints."""
    module = _load(TWINS[twin])
    if twin == "quickstart":
        res, fed_res, trainer = module.main(rounds=2, device="cpu")
        visits = [m["client"] for m in res.round_metrics]
        assert trainer.walker.history[:len(visits)] == visits
        assert math.isfinite(res.final["loss_personalized"])
        assert math.isfinite(fed_res.final["loss_global"])
        assert "RWSADMM comm/round" in capsys.readouterr().out
        return
    algos = module.ALGOS + ["rwsadmm_cf", "walkman"]
    rows = module.run(rounds=2, out_dir=str(tmp_path), device="cpu",
                      algos=algos)
    assert [(r["dataset"], r["model"], r["algo"]) for r in rows] == [
        (d, m, a) for d in ("mnist_like", "synthetic")
        for m in ("mlr", "mlp") for a in algos]
    assert all(math.isfinite(r["loss"]) and r["comm_mb"] > 0 for r in rows)
    assert [r["rounds"] for r in rows[:len(algos)]] == [2] * 7 + [8]
    assert (tmp_path / "table1_torch.csv").read_text().count("\n") == 33


@pytest.mark.parametrize("twin", sorted(PAPER_TWINS))
def test_paper_twin_runs_on_cpu(twin, tmp_path, capsys):
    """Each paper-script twin end to end with ``device="cpu"`` at 2
    rounds (Walkman's ablation 10; Table 2 at 2 clients for a round
    each): finite results and the reference's output lines. The walk
    policy sweep runs at its smoke size (40 rounds, two seeds), where
    its acceptance assertion is meant to hold."""
    path = PAPER_TWINS[twin]
    module = (importlib.import_module(f"benchmarks.{path.stem}")
              if path.parent.name == "benchmarks" else _load(path))
    out = str(tmp_path)
    if twin == "convergence":
        curves = module.run(rounds=2, out_dir=out, device="cpu")
        assert sorted(curves) == sorted((m, a) for m in ("mlr", "mlp")
                                        for a in module.ALGOS)
        assert all(list(r) == [2] and math.isfinite(a[0])
                   for r, a in curves.values())
        assert (tmp_path / "convergence_torch.csv").exists()
    elif twin == "table2_scaling":
        rows = module.run(out, "cpu", clients=(2,), rounds_per_client=1)
        assert rows[0]["rounds"] == 2 and rows[0]["comm_mb"] > 0
        assert math.isfinite(rows[0]["acc"])
    elif twin == "hyperparam":
        rows = module.run(rounds=2, out_dir=out, device="cpu")
        assert [(r["param"], r["value"]) for r in rows] == \
            [("beta", b) for b in module.BETAS] + \
            [("kappa", k) for k in module.KAPPAS]
    elif twin == "mixing":
        report = module.mixing_report()
        assert [r["holds"] for r in report] == [True, False, True, False,
                                                True]
        rows = module.policy_sweep(smoke=True, device="cpu",
                                   out=str(tmp_path / "rows.json"))
        assert [r["name"] for r in rows] == [
            f"walk_policy/{p}" for p in ("degree", "metropolis",
                                         "staleness", "label_skew")]
        assert all(r["device"] == "cpu" for r in rows)
        assert "policy_acceptance" in capsys.readouterr().out
    elif twin == "ablations":
        res = module.run(rounds=2, device="cpu")
        assert res["literal_eq11_first_step"] == 0.0
        assert res["walkman(consensus)"]["rounds"] == 10
        assert all(math.isfinite(v["acc"]) for k, v in res.items()
                   if isinstance(v, dict))
    else:
        rows = module.main(rounds=2, device="cpu")
        assert sorted(r[0] for r in rows) == sorted(
            list(module.BASELINES) + ["RWSADMM"])
        assert "comm_MB" in capsys.readouterr().out
