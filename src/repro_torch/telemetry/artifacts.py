"""Atomic on-disk artifacts shared by telemetry runs and benchmarks (port
of ``repro/telemetry/artifacts.py``).

Everything durable the repo writes — run manifests, ``BENCH_torch_scaling.json``
rows, rendered reports — goes through :func:`atomic_write_text` /
:func:`atomic_write_json`: write to a temp file in the target directory,
fsync, then ``os.replace``, so an interrupted writer can never leave a
truncated artifact behind (readers see the old file or the new one,
nothing in between).

Benchmark rows additionally merge through :func:`merge_bench_rows`,
keyed by ``(name, n, K, engine)`` — partial benchmark runs update their
own rows without clobbering the rest of the trajectory file.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any

#: identity of one benchmark row in a bench trajectory file
BENCH_ROW_KEY = ("name", "n", "K", "engine")


def atomic_write_text(path: str, text: str) -> str:
    """Durably replace ``path`` with ``text`` (temp file + os.replace)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def atomic_write_json(path: str, obj: Any, *, indent: int = 1) -> str:
    return atomic_write_text(
        path, json.dumps(obj, indent=indent, sort_keys=False) + "\n")


def _row_key(row: dict) -> tuple:
    return tuple(row.get(k) for k in BENCH_ROW_KEY)


def merge_bench_rows(existing: list[dict], rows: list[dict]) -> list[dict]:
    """Merge ``rows`` into ``existing`` keyed by ``(name, n, K, engine)``
    (new rows win their own key; everything else is preserved), sorted
    by key for stable diffs."""
    merged = {_row_key(r): r for r in existing}
    for r in rows:
        merged[_row_key(r)] = r
    return [merged[k] for k in sorted(merged, key=lambda t: tuple(
        (v is None, v) for v in t))]


def load_bench_rows(path: str) -> list[dict]:
    """Rows currently in a bench trajectory file ([] when absent)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f)
