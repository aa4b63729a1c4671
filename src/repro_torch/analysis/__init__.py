"""The port's static analysis (the JAX package's ``analysis/``): lint
rules, the captured-window audit, the capture budget.

Three layers, one CLI (``python -m repro_torch.analysis.check``):

1. **AST lint** (``lint.py`` / ``rules.py``): ambient numpy and torch
   sampling, unseeded generators, threefry key reuse, host syncs and
   tensor branches in the code a captured window runs, leftover debugging,
   mutable defaults. Suppress a finding inline with
   ``# repro_torch: allow(<rule>) -- <why>``.
2. **window audit** (``window_audit.py`` / ``registry.py``): every round
   and window call of the trainer × engine × plane × sharding matrix,
   traced on the CPU with ``make_fx``: no float64, no host read, no baked
   constant above the call's budget.
3. **capture budget** (``capture_budget.py``): the CUDA-graph captures of
   a fixed smoke sweep against ``analysis/capture_budget_torch.json``.
"""
from .findings import Finding
from .lint import LintEngine, lint_paths
from .rules import ALL_RULES
from .window_audit import WindowAudit, audit_window

__all__ = ["Finding", "LintEngine", "lint_paths", "ALL_RULES",
           "WindowAudit", "audit_window"]
