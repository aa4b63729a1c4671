"""Run-scoped telemetry recorder: manifest + JSONL event stream (port of
``repro/telemetry/recorder.py``).

A :class:`TelemetryRun` owns one run directory (``runs/<id>/`` by
default) holding:

* ``manifest.json`` — config, seed, git SHA, the ``torch`` block (torch
  and CUDA versions, the device's name, count and power limit) where the
  reference has its ``jax`` block, package versions, status; written
  atomically at open, on :meth:`update_manifest`, and at :meth:`close`.
* ``events.jsonl``  — the typed event stream (``telemetry.events``),
  one line per event, appended as the run executes.
* ``profile/``      — optional ``torch.profiler`` traces
  (``telemetry.profiler``, opt-in).

Every layer of the stack emits into the same run: ``run_simulation``
(rounds, snapshots, phase spans), the trainers' scan drivers (schedule
precompute / chunk execution spans), ``Scenario.schedule`` (rollout
spans), and the walk/zone trace stream (``telemetry.trace``). The
recorder never touches an RNG and never forces a device sync the caller
didn't ask for (phase fencing is explicit via :meth:`PhaseSpan.fence`),
and nothing of it runs inside a captured CUDA graph, so telemetry-on
trajectories are bit-identical to telemetry-off (pinned in
``tests/test_torch_telemetry.py``).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Any

from . import events as ev
from .artifacts import atomic_write_json

log = logging.getLogger("repro_torch.telemetry")

#: manifest keys that must be identical across runs of the same seeded
#: workload on the same checkout/toolchain (the determinism contract
#: asserted by manifest_fingerprint and its test).
DETERMINISTIC_MANIFEST_KEYS = (
    "schema_version", "seed", "config", "git_sha", "torch", "packages",
)


def _git_sha() -> str | None:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def _environment() -> tuple[dict, dict]:
    """(torch runtime info, package versions): torch and CUDA versions,
    and on a card its name, count and ``nvidia-smi``'s power limit."""
    import numpy
    import torch

    tx: dict[str, Any] = {"version": torch.__version__,
                          "cuda": torch.version.cuda,
                          "backend": "cpu", "device_count": 0,
                          "devices": [], "power_limit": None}
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
        tx.update(backend="cuda", device_count=count,
                  devices=[torch.cuda.get_device_name(i)
                           for i in range(count)],
                  power_limit=smi.stdout.strip().splitlines()[0])
    pkgs = {"python": ".".join(map(str, sys.version_info[:3])),
            "torch": torch.__version__, "numpy": numpy.__version__}
    return tx, pkgs


def manifest_fingerprint(manifest: dict) -> str:
    """sha256 over the deterministic manifest subset — two runs of the
    same seeded workload on the same checkout must agree on this even
    though run ids and timestamps differ."""
    sub = {k: manifest.get(k) for k in DETERMINISTIC_MANIFEST_KEYS}
    blob = json.dumps(sub, sort_keys=True, separators=(",", ":"),
                      default=ev._json_default)
    return hashlib.sha256(blob.encode()).hexdigest()


class PhaseSpan:
    """One fenced phase-timer span (context manager).

    The span opens at ``__enter__`` and records at ``__exit__``. Given a
    CUDA ``device`` it also records a CUDA event on that device's current
    stream when it opens, and :meth:`fence` records and waits on a second
    one: call it on the span's device values before the context closes,
    so the span measures completed device work and carries that work's
    ``device_seconds``, not enqueue time. The fence is explicit (never
    implicit), so a span can also time pure host work without a sync,
    and a span without a device (a host thread's) touches no CUDA state.
    """

    def __init__(self, run: "TelemetryRun", name: str, meta: dict,
                 device=None):
        self._run = run
        self.name = name
        self.meta = meta
        self.device = device
        self.seconds: float | None = None
        self.device_seconds: float | None = None
        self._start = None

    def fence(self, value=None):
        """Wait for the device work queued so far on the current stream
        (an event recorded after it, then waited on), pass ``value``
        through. The span then covers the work that produced it."""
        import torch

        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            end.synchronize()
            self.device_seconds = self._start.elapsed_time(end) / 1e3
        return value

    def __enter__(self) -> "PhaseSpan":
        if self.device is not None and self.device.type == "cuda":
            import torch

            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.seconds = time.perf_counter() - self._t0
        if exc_type is None:
            # ``t0`` (seconds since the run opened) places the span on
            # the run's timeline (the prefetch staging span beside the
            # scan_chunk span it hides behind). Wall-clock, so (like
            # ``seconds``) outside the byte-identical-events contract.
            extra = ({} if self.device_seconds is None
                     else {"device_seconds": self.device_seconds})
            self._run.emit("phase", name=self.name,
                           seconds=self.seconds,
                           t0=round(self._t0 - self._run._t_open, 6),
                           **extra, **self.meta)


class _NullSpan(PhaseSpan):
    """Phase span with no recorder attached (telemetry off): no events,
    no fence, nothing recorded."""

    def __init__(self):  # noqa: D401 - trivial
        super().__init__(None, "", {})  # type: ignore[arg-type]

    def fence(self, value=None):
        return value

    def __enter__(self) -> "PhaseSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


def null_phase() -> PhaseSpan:
    """A span that records nowhere: what phase-timer call sites use when
    no telemetry run is attached, keeping the off path sync-free."""
    return _NullSpan()


class TelemetryRun:
    """One recorded run: manifest + event stream under ``run_dir``.

    Parameters
    ----------
    run_dir:  explicit directory for this run's artifacts; or
    root/run_id: ``<root>/<run_id>`` (``run_id`` defaults to a
              wall-clock + pid tag — pass one for reproducible paths).
    config:   free-form JSON-serializable run configuration, captured
              verbatim in the manifest (and in its fingerprint).
    seed:     the run's base RNG seed (manifest + fingerprint).
    profile:  opt-in ``torch.profiler`` tracing (``telemetry.profiler``).
    """

    def __init__(self, run_dir: str | None = None, *, root: str = "runs",
                 run_id: str | None = None, config: dict | None = None,
                 seed: int | None = None, profile: bool = False):
        if run_dir is None:
            if run_id is None:
                run_id = time.strftime("%Y%m%d-%H%M%S") + f"-{os.getpid()}"
            run_dir = os.path.join(root, run_id)
        self.run_dir = run_dir
        self.run_id = run_id or os.path.basename(os.path.normpath(run_dir))
        self.profile = bool(profile)
        self.events_path = os.path.join(run_dir, "events.jsonl")
        self.manifest_path = os.path.join(run_dir, "manifest.json")
        os.makedirs(run_dir, exist_ok=True)
        self._fh = open(self.events_path, "a", buffering=1)
        # Serializes appends: the lazy plane's prefetch worker emits its
        # staging phase span from a background thread while the main
        # thread streams round events.
        self._emit_lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._t_open = time.perf_counter()
        tx, pkgs = _environment()
        self.manifest: dict[str, Any] = {
            "schema_version": ev.SCHEMA_VERSION,
            "run_id": self.run_id,
            "created_unix": time.time(),
            "seed": seed,
            "config": config or {},
            "git_sha": _git_sha(),
            "torch": tx,
            "packages": pkgs,
            "events": "events.jsonl",
            "status": "open",
        }
        self.manifest["fingerprint"] = manifest_fingerprint(self.manifest)
        self._write_manifest()

    # -- manifest ---------------------------------------------------------
    def _write_manifest(self) -> None:
        atomic_write_json(self.manifest_path, self.manifest)

    def update_manifest(self, **fields) -> None:
        """Merge fields into the manifest and rewrite it atomically.
        ``config`` merges key-wise (late writers — e.g. run_simulation
        adding engine/rounds — extend rather than clobber), and the
        fingerprint is recomputed since config is part of it."""
        cfg = fields.pop("config", None)
        if cfg:
            self.manifest["config"] = {**self.manifest["config"], **cfg}
        self.manifest.update(fields)
        self.manifest["fingerprint"] = manifest_fingerprint(self.manifest)
        self._write_manifest()

    # -- event stream -----------------------------------------------------
    def emit(self, etype: str, **fields) -> None:
        """Append one typed event to ``events.jsonl``."""
        if self._fh.closed:
            raise ev.TelemetryError(
                f"telemetry run {self.run_id!r} is closed")
        line = ev.encode_event({"t": etype, **fields})
        with self._emit_lock:
            self._fh.write(line + "\n")
            self._counts[etype] = self._counts.get(etype, 0) + 1

    def round(self, metrics: dict) -> None:
        """One training round's ``round_metrics`` entry."""
        self.emit("round", **metrics)

    def visit(self, **fields) -> None:
        self.emit("visit", **fields)

    def snapshot(self, snap: dict) -> None:
        self.emit("snapshot", **snap)

    def counter(self, name: str, value) -> None:
        self.emit("counter", name=name, value=value)

    def phase(self, name: str, *, device=None, **meta) -> PhaseSpan:
        """A fenced phase-timer span (see :class:`PhaseSpan`), with CUDA
        events on ``device``'s current stream when it is a card:

        >>> with run.phase("scan_chunk", engine="scan") as sp:
        ...     state, stacked = trainer.run_chunk(state, sched)
        ...     sp.fence(stacked)
        """
        return PhaseSpan(self, name, meta, device)

    # -- console ----------------------------------------------------------
    def log(self, msg: str) -> None:
        """Route human-facing progress lines through the telemetry
        logger (stderr handler installed lazily so library users who
        configure logging themselves are not double-printed)."""
        telemetry_print(msg)

    # -- lifecycle --------------------------------------------------------
    def close(self, **fields) -> None:
        """Finalize: flush events, stamp status/wall time/event counts."""
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()
        self.update_manifest(
            status="finalized",
            wall_time_s=round(time.perf_counter() - self._t_open, 6),
            event_counts=dict(sorted(self._counts.items())),
            **fields)

    def __enter__(self) -> "TelemetryRun":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(**({"status": "failed"} if exc_type else {}))


def telemetry_print(msg: str) -> None:
    """Print via the ``repro.telemetry`` logger, installing a bare
    stderr handler on first use when the app configured none — the
    replacement for ad-hoc ``print()`` progress lines."""
    if not log.handlers and not logging.getLogger().handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(message)s"))
        log.addHandler(h)
        log.setLevel(logging.INFO)
    log.info(msg)
