"""Shared layers of the model zoo (the JAX package's ``models/layers.py``).

Parameters follow the reference's shapes: a dense weight is (n_in, n_out)
and applies as ``x @ w``. Parameters and activations are in the config's
dtype (bf16 at full width); normalisation statistics and RoPE angles are
fp32. Inits walk the reference's key tree: a module's
``reset_parameters(key)`` splits its threefry key (``core/prng.py``) as
the reference's ``*_init`` does, and each weight is ``jax.random.normal``
under its key in fp32, times its scale (one fp32 product), cast to the
weight's dtype, drawn in blocks of rows on the key's device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import prng


def torch_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal_init(p: torch.Tensor, key: torch.Tensor, scale: float) -> None:
    """Fill ``p`` with the reference's ``(jax.random.normal(key, p.shape,
    float32) * scale).astype(p.dtype)``: the scale rounded to fp32, one
    fp32 product, then the cast. ``key`` lies on ``p``'s device."""
    s = float(np.float32(scale))
    rows = p.detach().view(-1, p.shape[-1])
    with torch.no_grad():
        for r0, r1, draw in prng.normal_blocks(key, p.shape):
            rows[r0:r1].copy_(draw * s)


def dense_init(p: torch.Tensor, key: torch.Tensor,
               scale: float | None = None) -> None:
    """A (n_in, n_out) weight at scale 1/√n_in unless given."""
    normal_init(p, key, scale if scale is not None
                else 1.0 / np.sqrt(p.shape[0]))


def embedding_init(p: torch.Tensor, key: torch.Tensor) -> None:
    """A (vocab, d) table at scale 1/√d."""
    normal_init(p, key, 1.0 / np.sqrt(p.shape[1]))


def param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ------------------------------------------------------------- norms ------
class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype, device=None):
        super().__init__()
        self.scale = param(d, dtype=dtype, device=device)

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p.scale.float()).to(x.dtype)


# ------------------------------------------------------------- RoPE -------
def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Rotates
    the two halves of hd (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)
    angles = positions[..., None].float() * freqs        # (..., S, hd/2)
    angles = angles[..., None, :]                        # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor,
                theta: float) -> torch.Tensor:
    """M-RoPE (Qwen2-VL): hd splits into (temporal, height, width)
    sections of hd/2, hd/4 and hd/4, each rotated by its own position
    track as a RoPE of its own width (so each section has its own
    frequencies). x: (B, S, H, hd); positions_3d: (3, B, S)."""
    hd = x.shape[-1]
    sec = (hd // 2, hd // 4, hd - hd // 2 - hd // 4)
    parts, off = [], 0
    for i, s in enumerate(sec):
        parts.append(apply_rope(x[..., off:off + s], positions_3d[i], theta))
        off += s
    return torch.cat(parts, dim=-1)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Text tokens take the same index on all three M-RoPE tracks."""
    return torch.stack([positions] * 3, dim=0)


def sinusoidal_positions(seq: int, d: int) -> torch.Tensor:
    """The encoder's fixed (seq, d) table, [sin | cos] of pos / 10000^(2i/d),
    computed in float64 and returned in fp32, as the reference's."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / d)
    emb = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(emb.astype(np.float32))


# ------------------------------------------------------------- MLP --------
class MLP(nn.Module):
    """``w_in``/``w_out`` and, for SwiGLU (``act="silu"``), ``w_gate``."""

    def __init__(self, d: int, ff: int, act: str, *, dtype, device=None):
        super().__init__()
        self.act = act
        self.w_in = param(d, ff, dtype=dtype, device=device)
        self.w_out = param(ff, d, dtype=dtype, device=device)
        if act == "silu":
            self.w_gate = param(d, ff, dtype=dtype, device=device)

    def reset_parameters(self, key: torch.Tensor) -> None:
        """The reference's ``mlp_init``: ``split(key, 3)`` for ``w_in``,
        ``w_out`` and ``w_gate``."""
        ks = prng.split(key, 3)
        dense_init(self.w_in, ks[0])
        dense_init(self.w_out, ks[1])
        if self.act == "silu":
            dense_init(self.w_gate, ks[2])


def mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p.w_in
    if act == "silu":
        h = F.silu(x @ p.w_gate) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return h @ p.w_out


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of an embedding table: ``table[ids]``; a DTensor
    table (the dry-run) through :func:`_dt_lookup`."""
    if hasattr(table, "device_mesh"):
        return _dt_lookup(table, ids)
    return table[ids]


def _dt_lookup(table, ids):
    """A vocab-parallel lookup (Megatron's): the table's width gathered,
    its vocab rows left split; each rank looks up the ids its rows hold,
    zeros elsewhere, and the partial rows are summed over the vocab's
    mesh dims. Written out in local ops, since DTensor's own rules for an
    index (its backward's ``index_put``) and for ``embedding`` (its
    masked partial) fail on some torch versions (2.11)."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    rows = [i for i, pl in enumerate(table.placements)
            if isinstance(pl, Shard) and pl.dim % 2 == 0]
    table = table.redistribute(mesh, [Shard(0) if i in rows else Replicate()
                                      for i in range(mesh.ndim)])
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    id_pls = [Replicate() if i in rows else pl
              for i, pl in enumerate(ids.placements)]
    ids = ids.redistribute(mesh, id_pls)
    local, idx = table.to_local(), ids.to_local()
    n = local.shape[0]
    lo = 0
    for i in rows:      # the block of the vocab this rank holds
        lo = lo * mesh.size(i) + mesh.get_local_rank(i)
    lo *= n
    own = (idx >= lo) & (idx < lo + n)
    out = F.embedding((idx - lo).clamp(0, n - 1), local) \
        * own.unsqueeze(-1).to(local.dtype)
    out_pls = [Partial() if i in rows else pl for i, pl in enumerate(id_pls)]
    shape = tuple(ids.shape) + (table.shape[1],)
    return DTensor.from_local(
        out, mesh, out_pls, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride()).redistribute(
            mesh, id_pls)


def batch_split_only(t: torch.Tensor) -> torch.Tensor:
    """``t``; a DTensor (the dry-run) with every split but that of its
    batch (dim 0) gathered. DTensor's einsum merges batch and head dims
    into one; where its parts are split over different mesh dims and the
    heads do not divide (4 xLSTM heads over a model axis of 16), the
    backward's view back to (batch, head) takes a wrong local shape."""
    if not hasattr(t, "device_mesh"):
        return t
    from torch.distributed.tensor import Replicate, Shard

    return t.redistribute(t.device_mesh, [
        pl if isinstance(pl, Shard) and pl.dim % t.ndim == 0
        else Replicate() for pl in t.placements])


def _dim_groups(src: tuple, dst: tuple) -> list[tuple[list, list]]:
    """The dims of ``src`` and ``dst`` (same numel) that a reshape maps
    onto each other, as (source dims, destination dims) groups."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        gi, gj = [i], [j]
        a = src[i] if i < len(src) else 1
        b = dst[j] if j < len(dst) else 1
        while a != b:
            if a < b:
                i += 1
                gi.append(i)
                a *= src[i]
            else:
                j += 1
                gj.append(j)
                b *= dst[j]
        groups.append(([d for d in gi if d < len(src)],
                       [d for d in gj if d < len(dst)]))
        i, j = i + 1, j + 1
    return groups


def _dt_reshape(t, shape):
    """A DTensor reshaped, its split dims first gathered where DTensor's
    view rule cannot keep them: a split dim must go to the first factor
    of a split (which must divide by the split) or lead a merge (and
    divide by the split); otherwise it is gathered whole first, as GSPMD
    regathers it (4 KV heads over a model axis of 16)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, pls = t.device_mesh, list(t.placements)
    split = {}
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            split.setdefault(pl.dim % t.ndim, []).append(i)
    gather = set()
    for src, dst in _dim_groups(tuple(t.shape), tuple(shape)):
        if len(src) == 1 and len(dst) == 1:
            continue
        for d in src:
            if d not in split:
                continue
            m = 1
            for i in split[d]:
                m *= mesh.size(i)
            ok = ((len(src) == 1 and shape[dst[0]] % m == 0)
                  or (len(dst) == 1 and d == src[0]
                      and t.shape[d] % m == 0))
            if not ok:
                gather.add(d)
    if gather:
        t = t.redistribute(mesh, [
            Replicate() if isinstance(pl, Shard) and pl.dim % t.ndim
            in gather else pl for pl in pls])
    return t.reshape(shape)


class _DTReshape(torch.autograd.Function):
    """:func:`_dt_reshape` forward and backward (a gradient's split dims
    can meet the same view rule going back)."""

    @staticmethod
    def forward(ctx, t, shape):
        ctx.shape = tuple(t.shape)
        return _dt_reshape(t, shape)

    @staticmethod
    def backward(ctx, g):
        return _dt_reshape(g, ctx.shape), None


def reshape(t: torch.Tensor, shape) -> torch.Tensor:
    """``t.reshape(shape)``; a DTensor (the dry-run) through
    :func:`_dt_reshape`."""
    if not hasattr(t, "device_mesh"):
        return t.reshape(shape)
    shape = tuple(shape)
    if -1 in shape:
        known = int(np.prod([d for d in shape if d != -1]))
        shape = tuple(t.numel() // known if d == -1 else d for d in shape)
    return _DTReshape.apply(t, shape)
