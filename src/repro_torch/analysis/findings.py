"""Finding: one analyzer hit, with a churn-stable fingerprint (the JAX
package's ``analysis/findings.py``, kept here so the port imports nothing
of it).

Fingerprints hash (rule, repo-relative path, whitespace-normalized
source line), not the line number, so a baseline survives unrelated
edits above a finding. The scheme is the reference's: the same finding
has the same fingerprint in both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str          # rule name, e.g. "ambient-torch-random"
    path: str          # repo-relative posix path
    line: int          # 1-based
    col: int           # 0-based
    message: str
    snippet: str = ""  # the offending source line, stripped

    @property
    def fingerprint(self) -> str:
        norm = " ".join(self.snippet.split())
        digest = hashlib.sha256(
            f"{self.rule}|{self.path}|{norm}".encode()).hexdigest()
        return digest[:16]

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "snippet": self.snippet,
            "fingerprint": self.fingerprint,
        }

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"[{self.rule}] {self.message}")
