"""The port stands alone: no JAX and nothing of ``repro`` in its import
graph, and its entry points default to the GPU instead of quietly running
on the CPU. The Table 1 and quickstart twins run end to end on the CPU at
a few rounds."""
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
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "kernel_ab.py",
    *TWINS.values(), *SCENARIO_TWINS]


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
        res, fed_res = module.main(rounds=2, device="cpu")
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
