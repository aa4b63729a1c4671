"""Sharding rules (the JAX package's ``launch/sharding.py``): parameter,
batch and KV-cache specs, and DTensor placements from them.

Policy (MaxText-style 2D "fsdp + tensor" sharding), as the reference's:
  * activations: batch over the data axes (("pod", "data") multi-pod).
  * weights: output-feature dim over "model" (tensor parallel), the other
    big dim over the data axes (ZeRO/FSDP storage).
  * MoE experts: expert dim over "model" (expert parallel); optional
    ZeRO-3 of the expert hidden dim over "data" (``zero3_moe``).
  * KV caches: batch over the data axes, the cache's sequence dim over
    "model"; with B = 1 (long_500k) the sequence dim goes over
    ("data", "model"), sequence-parallel decode.

A spec is a tuple with one entry per tensor dim: None, an axis name, or
a tuple of names (a dim split over several axes, the major axis first,
as JAX splits it). It compares with the reference's ``PartitionSpec``
as a tuple. Every rule is divisibility-checked against the mesh; a dim
that does not divide falls back to replication (``_spec``).

The rules go by the reference's leaf paths. The port's parameters are
per layer (``layers.{r·P + gi}.mix.wq``) where the reference stacks the
repeats of pattern index gi on a leading axis (``layers/{gi}/mix/wq``),
so :func:`param_spec` maps the name through ``convert``'s
correspondence, applies the reference's rule to the stacked shape and
drops the stacked leading None. Caches are per layer too:
:func:`cache_shardings` gives each of the port's cache leaves the rule
of the reference leaf it stands for. A mesh is a ``DeviceMesh`` or any
object whose ``shape`` maps axis names to sizes (the reference tests'
stand-in).
"""
from __future__ import annotations

import numpy as np
from torch.distributed.tensor import Replicate, Shard

from ..models.transformer import ATTENTION

#: the port's top-level names that are layer stacks in the reference
STACKS = ("layers", "enc_layers", "dec_layers")


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name → size."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in axes]))


def _fits(mesh, dim_size: int, axes) -> bool:
    return dim_size % _axis_size(mesh, axes) == 0


def _entry(axes):
    """A one-axis tuple as its name, as ``PartitionSpec`` holds it."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def _spec(mesh, shape, wanted: list) -> tuple:
    """Per-dim wanted axes with the divisibility fallback (extra entries
    of ``wanted`` past the tensor's rank are dropped, as ``zip`` drops
    them in the reference)."""
    return tuple(_entry(axes) if axes and _fits(mesh, size, axes) else None
                 for size, axes in zip(shape, wanted))


def reference_path(name: str, cfg) -> tuple[str, bool]:
    """A port parameter's name → (the reference's leaf path, whether the
    reference stacks it on a leading layer axis): ``layers.{l}.mix.wq`` →
    ``layers/{l mod P}/mix/wq``, ``enc_layers.{l}.attn.wq`` →
    ``enc_layers/attn/wq``, ``final_norm.scale`` → ``final_norm/scale``."""
    parts = name.split(".")
    if parts[0] == "layers":
        gi = int(parts[1]) % len(cfg.layer_pattern)
        return "/".join(["layers", str(gi)] + parts[2:]), True
    if parts[0] in STACKS:
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


def _param_rule(path: str, shape, cfg, mesh, fsdp, *, zero3_moe: bool,
                embed_mode: str, rglru_row_parallel: bool) -> tuple:
    """The reference's ``param_spec`` on its own leaf path and shape."""
    name = path.split("/")[-1]
    stacked = ("layers/" in path or "enc_layers" in path
               or "dec_layers" in path)
    lead = [None] if stacked else []
    body = shape[1:] if stacked else shape

    def build(wanted):
        return _spec(mesh, shape, lead + wanted)

    # MoE experts (E, d, h) / (E, h, d); the router replicated. This
    # branch comes first, so an MoE config's shared expert takes the
    # expert rule cut to its rank, as in the reference.
    if "/ffn/" in path and cfg.moe is not None:
        if name == "router":
            return build([None, None])
        if name in ("w_in", "w_gate"):
            return build(["model", None, fsdp if zero3_moe else None])
        if name == "w_out":
            return build(["model", fsdp if zero3_moe else None, None])
    if "/shared/" in path:
        if name in ("w_in", "w_gate"):
            return build([fsdp, "model"])
        if name == "w_out":
            return build(["model", fsdp])

    # embeddings, head, positional tables
    if name == "embed":
        if embed_mode == "tp_d":
            return _spec(mesh, shape, [None, "model"])
        return _spec(mesh, shape, ["model", fsdp])
    if name == "head":
        return _spec(mesh, shape, [fsdp, "model"])
    if name in ("pos_embed", "dec_pos"):
        return _spec(mesh, shape, [None, fsdp])

    # norms, small vectors
    if name in ("scale", "b_gates", "lam") or len(body) <= 1:
        return build([None] * len(body))

    # projections
    if rglru_row_parallel and name in ("w_rg", "w_ig"):
        return build(["model", fsdp])
    if name in ("wq", "wk", "wv", "w_in", "w_gate", "w_up", "w_gate_up",
                "w_x", "w_g", "w_rg", "w_ig", "w_gates", "r_gates",
                "w_if", "projector"):
        return build([fsdp, "model"])
    if name in ("wo", "w_out", "w_down"):
        return build(["model", fsdp])
    if name == "conv_w":
        return build([None, "model"])
    return build([None] * len(body))


def param_spec(name: str, shape, cfg, mesh,
               data_axes: tuple[str, ...] | None, *,
               zero3_moe: bool = False, embed_mode: str = "model",
               rglru_row_parallel: bool = False) -> tuple:
    """The spec of the port's parameter ``name`` of ``shape``.
    ``data_axes=None`` turns FSDP storage off (pure tensor parallel);
    ``zero3_moe``, ``embed_mode="tp_d"`` and ``rglru_row_parallel`` are
    the reference's variants."""
    path, stacked = reference_path(name, cfg)
    shape = tuple(shape)
    full = (1,) + shape if stacked else shape
    spec = _param_rule(path, full, cfg, mesh, data_axes,
                       zero3_moe=zero3_moe, embed_mode=embed_mode,
                       rglru_row_parallel=rglru_row_parallel)
    return spec[1:] if stacked else spec


def params_shardings(named, cfg, mesh, data_axes, *, zero3_moe=False,
                     embed_mode="model", rglru_row_parallel=False
                     ) -> dict[str, tuple]:
    """Name → spec of every parameter of ``named`` (a module, or a dict
    of tensors keyed by its parameter names, such as a train state's x)."""
    items = (named.named_parameters() if hasattr(named, "named_parameters")
             else named.items())
    return {n: param_spec(n, p.shape, cfg, mesh, data_axes,
                          zero3_moe=zero3_moe, embed_mode=embed_mode,
                          rglru_row_parallel=rglru_row_parallel)
            for n, p in items}


def batch_shardings(cfg, mesh, data_axes: tuple[str, ...],
                    kind: str = "train", *, batch: int | None = None
                    ) -> dict[str, tuple]:
    """Input batch specs (keys as ``registry.batch_spec``'s). A batch that
    does not divide the data axes (B = 1 at long_500k) replicates."""
    dp = _entry(data_axes) if (batch is None
                               or _fits(mesh, batch, data_axes)) else None
    out = {"tokens": (dp, None)}
    if kind != "decode":
        if cfg.frontend == "vision_stub":
            out["patches"] = (dp, None, None)
        if cfg.frontend == "audio_stub":
            out["frames"] = (dp, None, None)
    return out


def _seq_axes(data_axes, batch: int) -> tuple:
    return ("model",) if batch > 1 else tuple(data_axes) + ("model",)


def _cache_rule(mesh, shape, dp, seq) -> tuple:
    """The reference's ``cache_shardings`` rule for a per-layer leaf of
    ``shape``, applied to its stacked (R, …) form, the lead dropped."""
    full = (1,) + tuple(shape)
    wanted = {5: [None, dp, seq, None, None],
              4: [None, dp, None, "model"],
              3: [None, dp, "model"],
              2: [None, dp]}.get(len(full))
    if wanted is None:
        return (None,) * len(shape)
    return _spec(mesh, full, wanted)[1:]


def cache_shardings(model, cfg, mesh, data_axes: tuple[str, ...],
                    batch: int, max_len: int) -> dict:
    """Specs mirroring ``model.init_cache(batch, max_len)``: ``step`` ()
    and, per layer, a ``KVCache`` of k/v (B, S, K, hd) specs (B over the
    data axes, S over "model", or over the data axes and "model" when
    B = 1) or a recurrent state's leaves by the reference's rank rule.
    A KV cache's ``length`` is a host int and has no spec."""
    from ..models import attention as attn_mod
    from ..models import recurrent as rec_mod

    seq = _seq_axes(data_axes, batch)
    states = {"rglru": rec_mod.rglru_init_state,
              "mlstm": rec_mod.mlstm_init_state,
              "slstm": rec_mod.slstm_init_state}
    layers = []
    for block in model.layers:
        if block.kind in ATTENTION:
            one = attn_mod.init_kv_cache(cfg, batch, max_len, block.kind,
                                         device="meta")
            spec = _cache_rule(mesh, one.k.shape, data_axes, seq)
            layers.append(one._replace(k=spec, v=spec, length=None))
        else:
            one = states[block.kind](cfg, batch, "meta")
            layers.append(type(one)(*(_cache_rule(mesh, t.shape, data_axes,
                                                  seq) for t in one)))
    return {"step": (), "layers": layers}


def whisper_cache_shardings(model, cfg, mesh, data_axes, batch: int,
                            max_len: int, *, project: bool = False) -> dict:
    """Specs mirroring an ``EncDecLM``'s ``init_cache(batch, max_len,
    enc_out, project=)``: the self-attention k/v and, with ``project``,
    the cross k/v by the KV rule; ``enc_out`` (B, T, d) with B over the
    data axes and d over "model"."""
    from ..models.attention import KVCache

    seq = _seq_axes(data_axes, batch)
    kv = _cache_rule(mesh, (batch, max_len, cfg.n_kv_heads, cfg.hd),
                     data_axes, seq)
    n = len(model.dec_layers)
    out = {"step": (),
           "enc_out": _spec(mesh, (batch, cfg.encoder_seq, cfg.d_model),
                            [data_axes, None, "model"]),
           "self_kv": [KVCache(k=kv, v=kv, length=None) for _ in range(n)]}
    if project:
        xkv = _cache_rule(mesh, (batch, cfg.encoder_seq, cfg.n_kv_heads,
                                 cfg.hd), data_axes, seq)
        out["cross_kv"] = [(xkv, xkv) for _ in range(n)]
    return out


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: each mesh dim that a
    tensor dim is split over holds ``Shard(dim)``, the others
    ``Replicate()``. A dim over a tuple of axes is split major axis
    first, which DTensor does when the axes come in mesh order (the
    rules give them so; another order raises)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {dim} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of one rank's shard (every split divides, by
    ``_spec``'s fallback)."""
    return tuple(size // _axis_size(mesh, axes)
                 for size, axes in zip(shape, tuple(spec)
                                       + (None,) * (len(shape) - len(spec))))
