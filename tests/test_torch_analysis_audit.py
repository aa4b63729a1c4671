"""The port's window audit: a clean call passes; an injected float64, a
host read (``.item()``, a copy to the CPU) and a baked constant each fire;
the lazy plane's rows fire as a constant unless they enter through the
store's buffers; the capture hook is off unless armed; the carry check
sees a state that is not the carry; and every cell of the trainer ×
engine × plane × sharding matrix audits clean (the one-rank mesh cells in
a fresh process each, which holds its own process group)."""
import types

import pytest
import torch

from repro_torch.analysis import registry
from repro_torch.analysis.registry import MATRIX, CellSpec, run_cell
from repro_torch.analysis.window_audit import (DEFAULT_CONST_BUDGET,
                                               audit_window, carry_aliasing,
                                               trace)
from _torch_dist import run_ranks
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def rules_of(report):
    return sorted(f.rule for f in report.findings)


# ------------------------------------------------------- toy calls --
def test_clean_call_passes():
    rep = audit_window("clean", lambda x: torch.tanh(x) * 2.0,
                       (torch.ones(8),))
    assert rep.ok and rep.n_nodes >= 2 and rep.const_bytes == 0


def test_float64_flagged():
    rep = audit_window("wide", lambda x: x.double() * 2.0,
                       (torch.ones(4),))
    # the cast and the product, each its own op
    assert rules_of(rep) == ["float64-op", "float64-op"]


def test_item_flagged():
    def f(x):
        return x * x.sum().item()
    rep = audit_window("sync", f, (torch.ones(4),))
    assert rules_of(rep) == ["host-sync-op"]


def test_copy_to_host_flagged():
    rep = audit_window("copy", lambda x: x.to("cpu", copy=True) + 1,
                       (torch.ones(4),))
    assert rules_of(rep) == ["host-sync-op"]


def test_baked_constant_flagged():
    big = torch.ones(100_000)                  # 400 KB constant
    rep = audit_window("baked", lambda x: x + big.sum(), (torch.ones(()),),
                       const_budget=256 * 1024)
    assert rules_of(rep) == ["baked-constant"]
    assert rep.const_bytes == 400_000


def test_baked_constant_within_budget_ok():
    big = torch.ones(100_000)
    rep = audit_window("dense", lambda x: x + big.sum(), (torch.ones(()),),
                       const_budget=1 << 20)
    assert rep.ok


def test_everything_broken_at_once():
    big = torch.ones(100_000)

    def f(s, x):
        v = s.sum().item()
        return (s.double() + x.double() + big.sum() * v).float()

    rep = audit_window("broken", f, (torch.ones(4), torch.ones(4)))
    assert set(rules_of(rep)) == {"baked-constant", "float64-op",
                                  "host-sync-op"}


def test_trace_leaves_the_arguments_untouched():
    x = torch.ones(4)

    def f(t):
        t.add_(1)
        return t
    gm = trace(f, (x,))
    assert torch.equal(x, torch.ones(4))
    assert any("add_" in str(n.target) for n in gm.graph.nodes)


# ------------------------------------------------ the trainer hooks --
def test_capture_is_off_unless_armed():
    trainer = registry.build_cell(CellSpec("single", "dense", False))
    registry.drive(trainer, "eager")
    assert trainer._audit_entries is None
    with trainer.capture_rounds() as entries:
        registry.drive(trainer, "scan")
    assert [e[0] for e in entries] == ["chunk:scan"]
    assert trainer._audit_entries is None


def test_lazy_rows_baked_in_fire():
    """The lazy plane's rows as a constant (the store's block read from
    the trainer, not handed in) exceed its budget: the check has teeth."""
    (call,) = [c for c in run_cell(CellSpec("single", "lazy", False),
                                   engines=("scan",))]
    assert call.audit().ok
    raw = call.fn.args[1]                 # the window, without the buffers
    rep = audit_window(call.name, raw, call.args[1:], call.kwargs,
                       const_budget=DEFAULT_CONST_BUDGET)
    assert rules_of(rep) == ["baked-constant"]


def test_carry_aliasing_sees_a_copy():
    carry = (torch.ones(3), torch.zeros(2))
    trainer = types.SimpleNamespace(_carry=carry, name="t")
    assert carry_aliasing(trainer, [carry, carry]) == []
    moved = (carry[0], carry[1].clone())
    (f,) = carry_aliasing(trainer, [carry, moved])
    assert f.rule == "carry-aliasing" and "replay 1: 1 of 2" in f.message


# ------------------------------------------------ the real matrix --
_SHARDED_CELL = """
from repro_torch.analysis.registry import CellSpec, run_cell
init_group()
spec = CellSpec({trainer!r}, {plane!r}, True)
out = []
for call in run_cell(spec):
    rep = call.audit()
    out.append([rep.name, [f.rule for f in rep.findings], rep.const_bytes,
                rep.const_budget])
emit(out)
"""


@pytest.mark.parametrize("spec", MATRIX, ids=lambda s: s.key)
def test_matrix_cell_audits_clean(spec, tmp_path):
    if spec.sharded:
        (rows,) = run_ranks(_SHARDED_CELL.format(trainer=spec.trainer,
                                                 plane=spec.plane),
                            1, tmp_path)
    else:
        rows = []
        for call in run_cell(spec):
            rep = call.audit()
            rows.append([rep.name, [f.rule for f in rep.findings],
                         rep.const_bytes, rep.const_budget])
    names = [r[0].rsplit("/", 1)[1] for r in rows]
    mode = {"fleet": "roundrobin:", "fleet_sim": "simultaneous:"}.get(
        spec.trainer, "")
    assert names == [f"round{':' + mode[:-1] if mode else ''}",
                     f"chunk:{mode}scan", f"chunk:{mode}scan_fused"]
    assert all(r[1] == [] for r in rows), rows
    if spec.plane == "lazy":
        # the store's packed rows enter as inputs, never as constants
        assert all(r[2] < 1024 for r in rows), rows
