"""Opt-in device-level profiling hooks (``torch.profiler``; port of
``repro/telemetry/profiler.py``, which wraps ``jax.profiler``).

Phase timers (``TelemetryRun.phase``) give wall-clock spans and, on a
card, their CUDA-event device time; when that is not enough, a run opened
with ``profile=True`` (or with ``REPRO_PROFILE=1`` in the environment)
also wraps its training loop in ``torch.profiler.profile`` and writes a
Chrome trace to ``runs/<id>/profile/trace.json``, and call sites can
name regions with :func:`annotate` (``torch.profiler.record_function``)
so the device timeline carries the event stream's phase names. Off, both
are no-ops. A profiler that fails raises: the run is not hidden from it.
"""
from __future__ import annotations

import contextlib
import os


def profiling_enabled(run=None) -> bool:
    """True when this run (or the environment) opted into profiling."""
    if run is not None and getattr(run, "profile", False):
        return True
    return os.environ.get("REPRO_PROFILE", "") not in ("", "0")


@contextlib.contextmanager
def maybe_trace(run=None):
    """``torch.profiler.profile`` over the wrapped block (the CPU, and
    CUDA where a card is present), its trace written under the run's
    ``profile/`` directory; a no-op unless profiling is enabled and a run
    directory exists to hold the trace."""
    if run is None or not profiling_enabled(run):
        yield None
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    logdir = os.path.join(run.run_dir, "profile")
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    run.update_manifest(profile_dir="profile")


def annotate(name: str):
    """A named region on the profiler's timeline (``record_function``)."""
    import torch

    return torch.profiler.record_function(name)
