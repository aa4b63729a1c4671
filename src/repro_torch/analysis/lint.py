"""AST lint engine: file discovery, rule execution, suppressions (the JAX
package's ``analysis/lint.py``).

Suppression syntax:

* ``# repro_torch: allow(rule-a, rule-b)`` on the offending line, or on a
  comment-only line directly above it, suppresses those rules there. A
  suppression must carry a justification after a ``--``::

      x = t.item()  # repro_torch: allow(host-sync-in-window) -- host path

* ``# repro_torch: allow-file(rule-a)`` in the first 20 lines suppresses a
  rule for the whole file (same ``--`` rule).

The reference's marker (``# repro: allow(...)``) is another marker: this
engine ignores it, and the reference's ignores this one. Suppressions that
fire are inventoried (``analysis/baseline_torch.json``); one with no
justification, and one that matches nothing, is a finding itself. A
file that does not parse is a ``syntax-error`` finding, not an exception.
The JAX package (``src/repro/``) is never linted.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Iterable, Sequence

from .findings import Finding
from .rules import ALL_RULES, ModuleContext, Rule

_ALLOW_RE = re.compile(
    r"#\s*repro_torch:\s*allow(?P<scope>-file)?\(\s*(?P<rules>[a-z0-9_,\s-]+)\)"
    r"(?P<just>\s*--\s*\S.*)?")

#: directories never linted (generated output, caches, build trees)
_SKIP_PARTS = {"__pycache__", ".git", "runs", "build"}
#: the reference package, never linted by the port's rules
_REFERENCE = "src/repro/"


@dataclasses.dataclass(frozen=True)
class Suppression:
    path: str
    line: int            # line the comment sits on
    rules: tuple[str, ...]
    file_wide: bool
    justified: bool


def parse_suppressions(path: str, source: str) -> list[Suppression]:
    """The live suppressions of a module: real COMMENT tokens only, so the
    syntax quoted in a docstring (this one's) registers nothing."""
    out = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(t.start[0], t.string) for t in tokens
                    if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, SyntaxError):   # unparseable: none
        return out
    for i, text in comments:
        m = _ALLOW_RE.search(text)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(",")
                      if r.strip())
        out.append(Suppression(
            path=path, line=i, rules=rules,
            file_wide=m.group("scope") == "-file",
            justified=m.group("just") is not None))
    return out


class LintEngine:
    def __init__(self, rules: Sequence[Rule] = ALL_RULES,
                 *, root: Path | None = None):
        self.rules = tuple(rules)
        self.root = Path(root) if root is not None else Path.cwd()

    def _rel(self, path: Path) -> str:
        rel = path.resolve()
        try:
            rel = rel.relative_to(self.root.resolve())
        except ValueError:
            pass
        return rel.as_posix()

    # -- file discovery -----------------------------------------------
    def iter_files(self, paths: Iterable[str | Path]):
        """The ``.py`` files under ``paths`` (files or directories),
        each once, never one of the reference package's."""
        seen: set[Path] = set()
        for p in paths:
            p = Path(p)
            if p.is_file() and p.suffix == ".py":
                files = [p]
            elif p.is_dir():
                files = [f for f in sorted(p.rglob("*.py"))
                         if not _SKIP_PARTS.intersection(f.parts)]
            else:
                files = []
            for f in files:
                if f.resolve() in seen or self._rel(f).startswith(
                        _REFERENCE):
                    continue
                seen.add(f.resolve())
                yield f

    # -- one file ------------------------------------------------------
    def lint_source(self, source: str, path: str) -> list[Finding]:
        """Run every rule on one module's source; apply suppressions."""
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            return [Finding(rule="syntax-error", path=path,
                            line=e.lineno or 1, col=(e.offset or 1) - 1,
                            message=f"cannot parse: {e.msg}",
                            snippet=(e.text or "").strip())]
        ctx = ModuleContext(path, source, tree)
        raw: list[Finding] = []
        for rule in self.rules:
            raw.extend(rule.check(ctx))
        # Dedupe (overlapping reachable subtrees can double-report).
        raw = sorted(set(raw), key=lambda f: (f.line, f.col, f.rule))

        sups = parse_suppressions(path, source)
        file_wide = {r for s in sups if s.file_wide and s.line <= 20
                     for r in s.rules}
        by_line: dict[tuple[int, str], Suppression] = {}
        for s in sups:
            if s.file_wide:
                continue
            for r in s.rules:
                # a same-line allow also covers the next line, so a
                # comment-only line can precede the offending statement
                by_line[(s.line, r)] = s
                by_line[(s.line + 1, r)] = s

        used: set[tuple[str, int, tuple[str, ...]]] = set()
        kept: list[Finding] = []
        unjustified: list[Finding] = []
        for f in raw:
            sup = by_line.get((f.line, f.rule))
            if f.rule in file_wide or sup is not None:
                if sup is not None:
                    used.add((sup.path, sup.line, sup.rules))
                    if not sup.justified:
                        unjustified.append(Finding(
                            rule="unjustified-suppression", path=path,
                            line=sup.line, col=0,
                            message=(f"allow({f.rule}) needs a '-- why'"
                                     " justification"),
                            snippet=f.snippet))
                continue
            kept.append(f)
        kept.extend(unjustified)
        for s in sups:
            if s.file_wide:
                if not s.justified:
                    kept.append(Finding(
                        rule="unjustified-suppression", path=path,
                        line=s.line, col=0,
                        message="allow-file(...) needs a '-- why' "
                                "justification", snippet=""))
                continue
            if (s.path, s.line, s.rules) not in used:
                kept.append(Finding(
                    rule="unused-suppression", path=path, line=s.line,
                    col=0,
                    message=(f"suppression for {', '.join(s.rules)} "
                             "matches no finding; remove it"),
                    snippet=""))
        return sorted(kept, key=lambda f: (f.line, f.col, f.rule))

    def lint_file(self, path: Path) -> list[Finding]:
        return self.lint_source(path.read_text(), self._rel(path))

    def run(self, paths: Iterable[str | Path]) -> list[Finding]:
        findings: list[Finding] = []
        for f in self.iter_files(paths):
            findings.extend(self.lint_file(f))
        return findings

    def suppression_inventory(self, paths: Iterable[str | Path]
                              ) -> list[dict]:
        """Every active suppression (the baselined-violation ledger)."""
        out = []
        for f in self.iter_files(paths):
            for s in parse_suppressions(self._rel(f), f.read_text()):
                out.append({"path": s.path, "line": s.line,
                            "rules": list(s.rules),
                            "file_wide": s.file_wide})
        return out


def lint_paths(paths: Iterable[str | Path], *,
               root: Path | None = None) -> list[Finding]:
    return LintEngine(root=root).run(paths)
