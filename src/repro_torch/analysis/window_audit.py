"""Layer 2: the captured-window auditor (the JAX package's
``analysis/jaxpr_audit.py``).

Every round and window call the trainers record
(``TrainerBase.capture_rounds`` keeps ``(name, fn, args, kwargs)`` at the
call sites) is traced on the CPU with ``make_fx`` in real mode, on clones
of its arguments: the trace goes through ``torch.func``'s vmap and grad
and the kernels' plain versions, op for op the work the card's window
captures. The graph is walked for what a captured window must not hold:

* **float64-op**: a node whose output is float64 or complex128 (the
  rounds are pinned to float32; a stray double doubles the bytes and
  breaks the bit-identity pins).
* **host-sync-op**: ``aten._local_scalar_dense`` or ``aten.item`` (a
  value read on the host: an error under capture, or a value baked into
  every replay), or a ``_to_copy`` to the CPU (the counterpart of the
  reference's ``callback-in-jit``). The trace records them instead of
  raising (``_error_on_data_dependent_ops=False``).
* **baked-constant**: the tensors the graph holds as constants (every
  tensor it reads that is not an input) above a byte budget. The dense
  plane's budget is its data's bytes plus 256 KiB; on the lazy plane the
  store's buffers enter as inputs (``registry.py``), so its rows must not
  show up as constants.

The reference's donation check has no like-for-like counterpart: the
port consumes its input state on every plane. Its own invariant,
:func:`carry_aliasing` (a window's returned state is the trainer's carry
and replays chain in place), runs on the card, where windows are
captured.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.fx.experimental.proxy_tensor import make_fx

from ..fl.base import snapshot
from .findings import Finding

_WIDE_DTYPES = {torch.float64, torch.complex128}
_HOST_SYNC = {"aten._local_scalar_dense", "aten.item"}

#: default constant budget for a call that must not bake bulk data
DEFAULT_CONST_BUDGET = 256 * 1024


@dataclasses.dataclass
class WindowAudit:
    """Result of auditing one recorded call."""
    name: str
    n_nodes: int
    const_bytes: int
    const_budget: int
    findings: list[Finding]

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {"name": self.name, "n_nodes": self.n_nodes,
                "const_bytes": self.const_bytes,
                "const_budget": self.const_budget,
                "findings": [f.to_dict() for f in self.findings]}


def trace(fn, args, kwargs=None) -> torch.fx.GraphModule:
    """``fn(*args, **kwargs)`` traced with ``make_fx`` in real mode on
    clones of ``args`` (a round consumes its state in place). Host reads
    are recorded, not raised."""
    kwargs = dict(kwargs or {})

    def call(*a):
        return fn(*a, **kwargs)

    return make_fx(call, tracing_mode="real",
                   _error_on_data_dependent_ops=False)(*snapshot(tuple(args)))


def constants(gm: torch.fx.GraphModule) -> dict:
    """The graph's tensor constants by name (each once)."""
    out = {}
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            val = getattr(gm, node.target, None)
            if isinstance(val, torch.Tensor):
                out[node.target] = val
    return out


def _outputs(node) -> list:
    val = node.meta.get("val")
    vals = val if isinstance(val, (list, tuple)) else [val]
    return [v for v in vals if isinstance(v, torch.Tensor)]


def audit_window(name: str, fn, args, kwargs=None, *,
                 const_budget: int = DEFAULT_CONST_BUDGET) -> WindowAudit:
    """Trace one recorded call and check the captured-window rules."""
    path = f"<window:{name}>"
    gm = trace(fn, args, kwargs)
    findings: list[Finding] = []
    const_bytes = sum(t.numel() * t.element_size()
                      for t in constants(gm).values())
    if const_bytes > const_budget:
        findings.append(Finding(
            rule="baked-constant", path=path, line=1, col=0,
            message=(f"{const_bytes} bytes of graph constants exceed the "
                     f"{const_budget}-byte budget — bulk data must enter "
                     "as an input (the store's buffers), not a constant"),
            snippet=name))
    n_nodes = 0
    wide_seen: set[str] = set()
    sync_seen: set[str] = set()
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        n_nodes += 1
        op = str(getattr(node.target, "_overloadpacket", node.target))
        to_cpu = (op == "aten._to_copy"
                  and str(node.kwargs.get("device")) == "cpu")
        if (op in _HOST_SYNC or to_cpu) and op not in sync_seen:
            sync_seen.add(op)
            findings.append(Finding(
                rule="host-sync-op", path=path, line=1, col=0,
                message=(f"'{op}' reads a value on the host inside the "
                         "window — a capture fails on it, or bakes its "
                         "value into every replay"),
                snippet=f"{name}:{op}"))
        for val in _outputs(node):
            if val.dtype in _WIDE_DTYPES and op not in wide_seen:
                wide_seen.add(op)
                findings.append(Finding(
                    rule="float64-op", path=path, line=1, col=0,
                    message=(f"'{op}' produces {val.dtype} — the rounds "
                             "are pinned to float32"),
                    snippet=f"{name}:{op}"))
    return WindowAudit(name=name, n_nodes=n_nodes, const_bytes=const_bytes,
                       const_budget=const_budget, findings=findings)


def _ptrs(tree) -> list[int]:
    from ..fl.rwsadmm_trainer import _leaves

    return [t.data_ptr() for t in _leaves(tree)]


def carry_aliasing(trainer, states) -> list[Finding]:
    """The card's invariant of a captured window: each state ``states``
    holds (returned by successive ``run_chunk`` replays of one window) is
    the trainer's carry, every tensor at the carry's address, so replays
    chain in place. Findings where one is not."""
    want = _ptrs(trainer._carry)
    out = []
    for i, state in enumerate(states):
        got = _ptrs(state)
        if got != want:
            moved = sum(a != b for a, b in zip(got, want)) + abs(
                len(got) - len(want))
            out.append(Finding(
                rule="carry-aliasing", path=f"<window:{trainer.name}>",
                line=1, col=0,
                message=(f"replay {i}: {moved} of {len(want)} returned "
                         "tensors are not the carry's — replays would not "
                         "chain in place"),
                snippet=f"{trainer.name}:replay{i}"))
    return out
