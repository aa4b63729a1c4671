"""Layer 2 registry: the trainer × engine × plane × sharding matrix (the
JAX package's ``analysis/registry.py``).

The auditor needs the live calls with their exact arguments: the only
faithful way to enumerate every round and window the trainers run is to
run a tiny workload with capture armed (``TrainerBase.capture_rounds``)
and collect what the trainers called. The matrix and workload are the
reference's:

* trainer: ``RWSADMMTrainer`` / ``FleetRWSADMMTrainer`` (round-robin),
  plus one simultaneous-fleet cell so ``_sim_step`` is covered;
* engine: ``eager`` (one round a call) and the ``scan`` / ``scan_fused``
  windows;
* plane: ``dense`` (the dataset a constant of the graph, deliberately)
  and ``lazy`` (the store's buffers enter as inputs: the traced call
  binds the trainer's ``data`` to them, so a constant near the store's
  packed bytes means the rows leaked back in);
* sharding: none, and a one-rank ``FLSharding`` mesh (a gloo group of
  one in this process when none exists; on a card, NCCL).

Workload: 8 clients, 400 synthetic MNIST rows, MLR; ``lossy_links`` with
the dense graph backend; zone 4, batch 16, ``closed_form``, β = 10; 2
eager rounds and 3-round windows.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Sequence

import numpy as np

from .window_audit import DEFAULT_CONST_BUDGET, WindowAudit, audit_window

N_CLIENTS = 8
EAGER_ROUNDS = 2
CHUNK_ROUNDS = 3
SCAN_ENGINES = ("scan", "scan_fused")
ENGINES = ("eager",) + SCAN_ENGINES

#: slack on top of the dense plane's data bytes (masks, keys, scalars)
_CONST_SLACK = 256 * 1024


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One cell of the audit matrix."""
    trainer: str          # "single" | "fleet" | "fleet_sim"
    plane: str            # "dense" | "lazy"
    sharded: bool

    @property
    def key(self) -> str:
        shard = "sharded" if self.sharded else "unsharded"
        return f"{self.trainer}/{self.plane}/{shard}"


#: the whole audited matrix (fleet_sim covers _sim_step once)
MATRIX: tuple[CellSpec, ...] = tuple(
    CellSpec(trainer, plane, sharded)
    for trainer in ("single", "fleet")
    for plane in ("dense", "lazy")
    for sharded in (False, True)
) + (CellSpec("fleet_sim", "dense", False),)

#: the capture-budget smoke subset (Layer 3), fixed so the golden counts
#: in analysis/capture_budget_torch.json stay comparable
SMOKE: tuple[CellSpec, ...] = (
    CellSpec("single", "dense", False),
    CellSpec("single", "lazy", False),
    CellSpec("fleet", "dense", False),
)


@dataclasses.dataclass
class RecordedCall:
    """One round or window call recorded by a trainer, audit-ready."""
    cell: str
    engine: str
    name: str             # the trainer's label, e.g. "chunk:scan"
    fn: object
    args: tuple
    kwargs: dict
    const_budget: int

    @property
    def key(self) -> str:
        return f"{self.cell}/{self.engine}/{self.name}"

    def audit(self) -> WindowAudit:
        report = audit_window(self.name, self.fn, self.args, self.kwargs,
                              const_budget=self.const_budget)
        report.name = self.key
        report.findings = [dataclasses.replace(f, path=f"<window:{self.key}>")
                           for f in report.findings]
        return report


@functools.lru_cache(maxsize=4)
def _workload(device: str = "cpu"):
    """The shared tiny federated workload (built once a process)."""
    from ..data import (build_federated, factory_from_federated,
                        make_image_dataset, pathological_split)
    from ..fl.base import to_device_data
    from ..models.small import get_model

    imgs, labels = make_image_dataset(400, seed=0)
    parts = pathological_split(labels, N_CLIENTS, seed=0)
    fed = build_federated(imgs, labels, parts)
    dense = to_device_data(fed, device)
    factory = factory_from_federated(fed)
    model = get_model("mlr", (28, 28, 1))
    return dense, factory, model


def one_rank_mesh():
    """A one-rank "data" mesh over this process's default group, which is
    started here when none exists: gloo on an in-process store on the CPU,
    ``make_data_mesh``'s NCCL group on a card."""
    import torch
    import torch.distributed as dist

    from ..launch.mesh import make_data_mesh

    if not dist.is_initialized() and not torch.cuda.is_available():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_data_mesh(1)


def build_cell(spec: CellSpec, device: str = "cpu"):
    """The trainer of one matrix cell, fresh at every call (the capture
    budget counts a trainer's own captures)."""
    from ..core.rwsadmm import RWSADMMHparams
    from ..fl.fleet_trainer import FleetRWSADMMTrainer
    from ..fl.rwsadmm_trainer import RWSADMMTrainer
    from ..fl.sharding import FLSharding
    from ..scenarios import get_scenario_config

    dense, factory, model = _workload(str(device))
    scen = dataclasses.replace(get_scenario_config("lossy_links"),
                               graph_backend="dense",
                               neighbor_k_max=N_CLIENTS)
    kw = dict(zone_size=4, batch_size=16, solver="closed_form",
              scenario=scen, seed=0, device=device,
              mesh=FLSharding(one_rank_mesh()) if spec.sharded else None)
    lazy = spec.plane == "lazy"
    data = factory if lazy else dense
    if lazy:
        kw["store_capacity"] = N_CLIENTS
    hp = RWSADMMHparams(beta=10.0)
    if spec.trainer == "single":
        return RWSADMMTrainer(model, data, hp, **kw)
    mode = "simultaneous" if spec.trainer == "fleet_sim" else "roundrobin"
    return FleetRWSADMMTrainer(model, data, hp, n_walkers=3,
                               sync_every=3, fleet_mode=mode, **kw)


def _nbytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree))


def _through_buffers(trainer, fn, data, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the trainer reading its client data
    from ``data`` (the traced inputs standing for the store's buffers)."""
    saved = trainer.data
    trainer.data = data
    try:
        return fn(*args, **kwargs)
    finally:
        trainer.data = saved


def drive(trainer, engine: str):
    """The cell's workload on one engine from a fresh state: 2 eager
    rounds, or one 3-round window."""
    state = trainer.init_state(0)
    if engine == "eager":
        rng = np.random.default_rng(0)
        for rnd in range(EAGER_ROUNDS):
            state, _ = trainer.round(state, rnd, rng)
        return state
    sched = trainer.schedule(CHUNK_ROUNDS, np.random.default_rng(1))
    return trainer.run_chunk(state, sched, engine=engine)[0]


def run_cell(spec: CellSpec, engines: Sequence[str] = ENGINES
             ) -> list[RecordedCall]:
    """Run one cell's workload with capture armed; return every distinct
    round or window call the trainers made, audit-ready."""
    trainer = build_cell(spec)
    lazy = spec.plane == "lazy"
    budget = (DEFAULT_CONST_BUDGET if lazy
              else _nbytes(trainer.data) + _CONST_SLACK)
    out: list[RecordedCall] = []
    for engine in engines:
        with trainer.capture_rounds() as entries:
            drive(trainer, engine)
        seen: set[str] = set()
        for name, fn, args, kwargs in entries:
            if name in seen:          # eager records one call a round
                continue
            seen.add(name)
            if lazy:
                fn = functools.partial(_through_buffers, trainer, fn)
                args = (trainer.data,) + tuple(args)
            out.append(RecordedCall(cell=spec.key, engine=engine, name=name,
                                    fn=fn, args=args, kwargs=kwargs,
                                    const_budget=budget))
    return out


def audit_matrix(cells: Iterable[CellSpec] = MATRIX,
                 engines: Sequence[str] = ENGINES) -> list[WindowAudit]:
    return [call.audit() for spec in cells
            for call in run_cell(spec, engines)]
