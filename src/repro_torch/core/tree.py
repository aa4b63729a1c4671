"""Flat parameter layout for the RWSADMM state.

The reference keeps every RWSADMM variable (client x_i, dual z_i, server
y) as a parameter pytree and flattens it for its fused kernel on every
call. The port holds them flat from the start: client x and z as one
``(n, P)`` fp32 buffer each, the token y as ``(P,)``. A
:class:`ParamLayout` names the leaves and hands out per-leaf views.

Leaves are keyed by ``nn.Module`` parameter names (``conv1.w``). Their
order is ``jax.tree_util.tree_leaves`` order on the reference's nested
param dict — keys sorted at every level (``conv1.b``, ``conv1.w``,
``conv2.b``, …) — so a flat vector here equals
``repro.core.tree.flatten`` of the same params element for element.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch


class ParamLayout:
    """Ordered leaf names (``nn.Module`` parameter names, ``"conv1.w"``)
    and shapes of one model's parameters."""

    def __init__(self, shapes: Mapping[str, tuple[int, ...]]):
        names = sorted(shapes, key=lambda k: tuple(k.split(".")))
        self.names: tuple[str, ...] = tuple(names)
        self.shapes: tuple[tuple[int, ...], ...] = tuple(
            tuple(int(d) for d in shapes[k]) for k in names)
        self.sizes: tuple[int, ...] = tuple(
            math.prod(s) for s in self.shapes)
        self.offsets: tuple[int, ...] = tuple(
            sum(self.sizes[:i]) for i in range(len(names)))
        self.size = sum(self.sizes)

    @classmethod
    def from_module(cls, module: torch.nn.Module) -> "ParamLayout":
        return cls({name: tuple(p.shape)
                    for name, p in module.named_parameters()})

    def views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Per-leaf views of ``flat`` (shape ``(..., P)``): leaf ``k``
        becomes ``(..., *shape_k)``. No copy when ``flat`` is contiguous."""
        lead = flat.shape[:-1]
        assert flat.shape[-1] == self.size, (flat.shape, self.size)
        out = {}
        for name, shape, off, size in zip(self.names, self.shapes,
                                          self.offsets, self.sizes):
            out[name] = flat[..., off:off + size].view(*lead, *shape)
        return out

    def flatten(self, leaves: Mapping[str, torch.Tensor],
                batch_dims: int = 0) -> torch.Tensor:
        """Concatenate leaves (keyed by name) into one ``(..., P)``
        tensor in layout order."""
        parts = []
        for name, shape in zip(self.names, self.shapes):
            leaf = leaves[name]
            lead = tuple(leaf.shape[:batch_dims])
            assert tuple(leaf.shape[batch_dims:]) == shape, (
                name, tuple(leaf.shape), shape)
            parts.append(leaf.reshape(*lead, -1))
        return torch.cat(parts, dim=-1)

    def n_bytes(self, dtype: torch.dtype = torch.float32) -> int:
        return self.size * torch.empty((), dtype=dtype).element_size()
