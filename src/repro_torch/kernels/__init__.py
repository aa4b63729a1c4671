"""Hand-written CUDA kernels, each beside its plain PyTorch version.

The flash-decode and RG-LRU scan wrappers also take shapes only: a meta
tensor goes through a ``torch.library.custom_op``
(``torch.ops.repro_torch.*``) whose fake implementation gives the
output's shape and dtype; a DTensor (the dry-run, ``launch/dryrun.py``)
through :func:`local_call`, which runs the op on each rank's shards. A
CPU or CUDA tensor never takes either route.
"""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, **tensors: torch.Tensor) -> None:
    """Raise where a kernel without a backward (flash decode, which no
    training path runs) would cut autograd: grad mode on and an input
    that requires grad. The CPU's plain version carries gradients, so
    only the CUDA path calls this."""
    needs = [name for name, t in tensors.items() if t.requires_grad]
    if needs and torch.is_grad_enabled():
        raise RuntimeError(
            f"{kernel} has no backward on the card, "
            f"and {', '.join(needs)} require grad: call it under "
            "torch.no_grad(), or on the CPU, whose plain version carries "
            "gradients")


def is_dtensor(t) -> bool:
    return hasattr(t, "device_mesh")


def local_call(fn, tensors, keep, out_shapes):
    """``fn(*locals)`` on DTensors ``tensors``, the way ``local_map`` runs a
    function on shards: every mesh dim that splits one of the first
    tensor's dims in ``keep`` keeps that split (the same dim of every
    tensor), every other placement is gathered (a plain tensor is taken
    as replicated); ``fn``'s outputs come back as DTensors of
    ``out_shapes``, placed alike. A scan needs S whole and keeps B and D
    split; decode keeps B split and gathers a cache split over S whole
    (no cross-shard combine of partial softmaxes)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    first = tensors[0]
    mesh = first.device_mesh
    pls = [pl if isinstance(pl, Shard) and pl.dim % first.ndim in keep
           else Replicate() for pl in first.placements]
    local = []
    for t in tensors:
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        local.append(t.redistribute(mesh, pls).to_local())
    out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    res = tuple(DTensor.from_local(
        o, mesh, pls, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())
        for o, shape in zip(outs, out_shapes))
    return res if isinstance(out, tuple) else res[0]
