"""Run a script on a few gloo ranks for the port's mesh tests.

A process group is global to a process, and pytest-xdist's ``--dist
loadfile`` runs other test files in the same worker, so no test starts
a group in its own process: ``run_ranks`` starts ``world`` fresh
processes, each of which runs ``script`` with ``RANK``, ``WORLD`` and
``STORE`` (a ``FileStore`` path under the test's ``tmp_path``: no TCP
port to collide between workers) in its environment, after
``init_group()`` (defined in the prelude) has joined them. Each process
prints one line ``RESULT <json>``; ``run_ranks`` returns the ranks'
objects in rank order.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = """
import json, os, sys
sys.path[:0] = [os.path.join({repo!r}, "src"), os.path.join({repo!r}, "tests")]
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD"])


def init_group():
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.environ["STORE"], WORLD),
        rank=RANK, world_size=WORLD)


def emit(obj):
    print("RESULT " + json.dumps(obj), flush=True)
"""


def run_ranks(script: str, world: int, tmp_path, *, timeout: int = 300,
              env: dict | None = None) -> list:
    store = os.path.join(str(tmp_path), f"store_{world}_{os.getpid()}")
    code = PRELUDE.format(repo=REPO) + script
    procs = []
    for rank in range(world):
        e = dict(os.environ, RANK=str(rank), WORLD=str(world), STORE=store,
                 JAX_PLATFORMS="cpu", **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=e, cwd=REPO))
    outs = []
    for rank, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank {rank}:\n{err[-4000:]}"
        lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
        assert lines, f"rank {rank} printed no result:\n{err[-2000:]}"
        outs.append(json.loads(lines[-1][len("RESULT "):]))
    return outs
