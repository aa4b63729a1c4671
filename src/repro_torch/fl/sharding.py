"""Client-plane sharding over a 1-D "data" mesh (the JAX package's
``fl/sharding.py``).

The FL trainers' big tensors share one layout: a leading client axis
(dense x/z ``(n, P)`` and the ``DeviceData`` columns ``(n, …)``) or, on the
lazy plane, the store's capacity axis ``(capacity, …)``. With a mesh,
each rank holds its contiguous block of that axis, rank r rows
[r·n/w, (r + 1)·n/w). An axis that does not divide the world size keeps
the whole leaf on every rank, as ``launch/sharding.py``'s ``_spec``
falls back. The server token, the fleet's (K, …) token stack, scalars,
``visited`` and the per-client counts ``n_train`` replicate.

A round does not index a DTensor (that gathers the whole plane and
cannot write back in place). :class:`RowPlane` does the row traffic
itself: a gather of rows ``idx`` takes each rank's own rows, with zeros
elsewhere, and sums them in one ``all_reduce`` over the group; the update
and the per-client gradients then run replicated on every rank, and
each rank writes back only the rows it owns (a row it does not own gets
-0.0, which changes no bit). A sum with exact zeros changes no bit but
the sign of a zero. On one rank every method is the plain op and no
collective is issued, so a one-rank mesh runs the meshless program
launch for launch (captured windows included).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..launch.mesh import make_data_mesh
from ..launch.sharding import _spec


class RowPlane:
    """One leading axis of ``n`` rows under an ``FLSharding``: this rank's
    block [lo, hi) (all rows when ``n`` does not divide, ``sharded``
    False) and the row ops on a leaf of that axis."""

    def __init__(self, sharding: "FLSharding", n: int):
        self.n = int(n)
        self.group = sharding.group
        world = sharding.n_devices
        self.sharded = world > 1 and self.n % world == 0
        per = self.n // world if self.sharded else self.n
        self.lo = sharding.rank * per if self.sharded else 0
        self.hi = self.lo + per

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole leaf (the leaf itself when not
        sharded)."""
        return t[self.lo:self.hi].clone() if self.sharded else t

    def _owned(self, idx: torch.Tensor):
        own = (idx >= self.lo) & (idx < self.hi)
        return own, (idx - self.lo).clamp(0, self.hi - self.lo - 1)

    def take(self, t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (global ids, any shape) of the leaf ``t``."""
        if not self.sharded:
            return t[idx]
        own, rows = self._owned(idx)
        mask = own.reshape(own.shape + (1,) * (t.dim() - 1))
        out = torch.where(mask, t[rows], t.new_zeros(()))
        dist.all_reduce(out, group=self.group)
        return out

    def take2(self, t: torch.Tensor, rows: torch.Tensor,
              cols: torch.Tensor) -> torch.Tensor:
        """``t[rows, cols]`` (a batch gather) for row ids ``rows``."""
        if not self.sharded:
            return t[rows, cols]
        own, local = self._owned(rows)
        out = t[local, cols]
        mask = own.expand(out.shape[:own.dim()]).reshape(
            out.shape[:own.dim()] + (1,) * (out.dim() - own.dim()))
        out = torch.where(mask, out, t.new_zeros(()))
        dist.all_reduce(out, group=self.group)
        return out

    def index_add_(self, t: torch.Tensor, idx: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
        """``t.index_add_(0, idx, values)`` on the rows this rank owns."""
        if not self.sharded:
            return t.index_add_(0, idx, values)
        own, rows = self._owned(idx)
        mask = own.reshape(own.shape + (1,) * (values.dim() - 1))
        return t.index_add_(0, rows, torch.where(
            mask, values, values.new_full((), -0.0)))

    def index_copy_(self, t: torch.Tensor, idx: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
        """``t.index_copy_(0, idx, values)`` on the rows this rank owns."""
        if not self.sharded:
            return t.index_copy_(0, idx, values)
        own = (idx >= self.lo) & (idx < self.hi)
        keep = own.nonzero().reshape(-1)
        return t.index_copy_(0, idx[keep] - self.lo, values[keep])

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf (n, …) from every rank's block."""
        if not self.sharded:
            return t
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(
            self.group))]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)


class FLSharding:
    """The mesh and each leaf's placement: rows over "data", or
    replicated."""

    def __init__(self, mesh=None, *, n_devices: int | None = None):
        self.mesh = mesh if mesh is not None else make_data_mesh(n_devices)
        if "data" not in self.mesh.mesh_dim_names:
            raise ValueError(f"FL mesh needs a 'data' axis, got "
                             f"{self.mesh.mesh_dim_names}")
        self.group = self.mesh.get_group("data")
        self.rank = self.mesh.get_local_rank("data")

    @property
    def n_devices(self) -> int:
        return int(self.mesh.size(self.mesh.mesh_dim_names.index("data")))

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_devices}

    # ---- per-leaf placements (specs, as launch/sharding.py's) ---------
    def row_sharding(self, leaf) -> tuple:
        """Leading axis over "data" (divisibility fallback → replicate)."""
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            return self.replicated_sharding()
        return _spec(self, shape, [("data",)] + [None] * (len(shape) - 1))

    def replicated_sharding(self) -> tuple:
        return ()

    def plane(self, n: int) -> RowPlane:
        return RowPlane(self, n)

    # ---- tree placement ------------------------------------------------
    def shard_rows(self, tree):
        """Every leaf's block of its leading axis on this rank (a leaf
        whose leading axis does not divide stays whole)."""
        return _map(tree, lambda t: self.plane(t.shape[0]).local(t)
                    if t.dim() else t)

    def replicate(self, tree):
        """Every leaf whole on every rank: what it already is."""
        return tree

    def row_shardings(self, tree):
        """The spec tree matching ``tree``."""
        return _map(tree, self.row_sharding)


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(_map(leaf, fn) for leaf in tree))
