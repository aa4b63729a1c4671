"""Meshes (the JAX package's ``launch/mesh.py``) as
``torch.distributed.device_mesh.DeviceMesh``es.

A ``DeviceMesh`` spans the ranks of the process's default group, and a
process has one default group. So every function here uses the group
that exists and raises when it has too few ranks; only
:func:`make_data_mesh` starts one itself, on the card and with one rank.
The production mesh of 256 or 512 ranks exists on a fake group
(``torch.testing._internal.distributed.fake_pg``) that the dry-run's
entry point makes in a process of its own (``launch/dryrun.py``): the
fake group takes the place of the reference's placeholder host devices
(``launch/hostdevices.py``), which get no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def device_type() -> str:
    """The default group's device type: ``cuda`` under NCCL, else
    ``cpu`` (gloo, and the dry-run's fake group)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _group_of(n: int) -> int:
    """The default group's world size, which must be at least ``n``."""
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n} ranks needs a default process "
                           "group; none is initialized")
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"requested {n} ranks, the default group has "
                         f"{world}")
    return world


def _mesh(shape: tuple, names: tuple) -> DeviceMesh:
    n = int(np.prod(shape))
    if _group_of(n) == n:
        return init_device_mesh(device_type(), shape,
                                mesh_dim_names=names)
    return DeviceMesh(device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16 × 16 = 256 ranks ("data", "model") per pod; two pods, (2, 16,
    16) ("pod", "data", "model"), multi-pod."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_data_mesh(n_devices: int | None = None) -> DeviceMesh:
    """1-D "data" mesh over the default group's ranks (or the first
    ``n_devices``): the client plane's shard unit is the leading client or
    capacity axis, so one data axis is the whole story.

    With no default group on a host with a GPU, it starts a one-rank NCCL
    group on the current card over an in-process store (a ``HashStore``:
    no address, no port) and returns the one-rank mesh; without a GPU it
    raises."""
    if not dist.is_initialized():
        if not torch.cuda.is_available():
            raise RuntimeError("no default process group, and no GPU to "
                               "start a one-rank group on")
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return _mesh((n,), ("data",))


def make_debug_mesh(n_data: int = 2, n_model: int = 2) -> DeviceMesh:
    """A small ("data", "model") mesh for tests."""
    return _mesh((n_data, n_model), ("data", "model"))


def data_axes(mesh) -> tuple[str, ...]:
    """The mesh's batch axes: "pod" and "data", those it has."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
