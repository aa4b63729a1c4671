"""Multi-pod dry-run (the JAX package's ``launch/dryrun.py``) on DTensors
over a fake process group.

For one (architecture × input shape × mesh): build the model on ``meta``
under a ``ShardingCtx``, place its parameters (a train state's x, z and
y alike), the batch and the KV cache as DTensors by the sharding rules
(``launch/sharding.py``), and run the step once with no data: train is
the loss and gradient through ``make_train_step``, prefill the loss
forward, decode the serve step. Nothing is allocated; the fake group
(``torch.testing._internal.distributed.fake_pg``, 256 ranks, 512
multi-pod) completes every collective at once. This process is rank 0.

What it records:

* ``flops``: the whole step, global. ``FlopCounterMode`` counts a DTensor
  op at its global shapes; the MoE layers' local-shard region
  (``moe.moe_parallel``) runs on plain tensors at one rank's shapes, so
  its count is scaled by the world size (every rank runs its own
  experts' share; the replicated routing counts once a rank).
* ``flops_per_rank``: the ops rank 0 runs, each counted at its local
  shards' shapes with ``torch.utils.flop_counter``'s formulas (a dispatch
  mode that lets DTensor turn each op into local ops and collectives
  first, then counts those). This and the collectives below are
  DTensor's plan (``plan``: "dtensor"), not GSPMD's: DTensor's sharding
  propagation replicates much that GSPMD splits (a rank's count is many
  times the even share, 1/256 of the global one), so they are not the
  reference's per-device cost.
* ``argument_bytes_per_rank``: the local shards' bytes of the params (or
  the train state), the batch and the cache, exactly; ``param_bytes_per_
  rank`` the params' alone.
* ``collectives``: per kind (the reference's names), the count and the
  bytes of the results a rank receives, read from the functional
  collectives DTensor issues; ``moe_collectives`` those of the MoE layers'
  forward (the ZeRO-3 gathers of the experts and the sum of the expert
  partials over "model", with the shared expert's redistribution). The kinds depend on the group's device
  type: the CPU's has no all-to-all, so a redistribution that would use
  one gathers instead; ``device_type`` says which ran.
* ``temp_bytes_per_rank``: null. The reference's ``memory_analysis``
  temporaries have no meta counterpart, and no tracker measures them
  here yet (ROADMAP).
* ``seconds`` and the process's ``peak_rss_bytes`` (its ``VmHWM``, null
  where the system reports none); ``cuda_initialized``
  (False: no CUDA context was made, so the card holds nothing of it).

A multi-pod mesh runs as its 2-D equivalent (:func:`_two_dim`):
``mesh`` records the production mesh, ``run_mesh`` the one run.

The reference's scan correction (``_variant_unit``, ``_variant_cfg``,
``_linear_correct``) has no counterpart: XLA counts a scanned layer
stack's body once, the port runs its layers in a Python loop and every
op is counted. Decode attention over a cache split over S (the cache
rule puts S over "model") gathers S whole before the flash-decode op;
there is no cross-shard combine of partial softmaxes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape train_4k [--multi-pod] [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from ..configs import ALL_ARCHS, INPUT_SHAPES, LONG_OK, get_config
from ..core.rwsadmm import RWSADMMHparams
from ..models import moe as moe_mod
from ..models.registry import batch_spec, build_model
from ..models.transformer import ShardingCtx
from . import sharding as shard_rules
from .mesh import data_axes as mesh_data_axes
from .mesh import device_type, make_production_mesh
from .steps import TrainState, make_train_step

DEFAULT_OPTIONS = {
    "ce_impl": "gather",     # "onehot" = sharded-vocab CE
    "fsdp_params": True,     # False = pure-TP params
    "embed_mode": "model",   # "tp_d" = collective-free token lookup
    "rglru_row_parallel": False,  # True = row-parallel RG-LRU gates
    "whisper_cross_kv": False,    # True = precomputed cross-attn K/V
}

#: functional collectives → the reference's collective names
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def fake_group(world_size: int) -> None:
    """Make this process rank 0 of a fake group of ``world_size`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def peak_rss_bytes() -> int | None:
    """This process's peak resident set (``VmHWM``), or None where the
    system does not report it (some sandboxed kernels). Not
    ``getrusage``'s ``ru_maxrss``: Linux carries that across ``exec``, so
    a process a large parent started would report the parent's peak."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024
    return None


def _bytes(t) -> int:
    return t.numel() * t.element_size()


class RankCounter(TorchDispatchMode):
    """Counts what one rank runs: a DTensor op is handed back to DTensor
    (``NotImplemented``), which turns it into local ops and functional
    collectives; those come through here with local shapes. ``flops``
    sums ``flop_registry``'s formulas over the local ops,
    ``local_region_flops`` the part run in the MoE local-shard region
    (``moe.moe_ffn`` on local tensors), and ``collectives`` counts each
    kind with its results' bytes, ``moe_collectives`` those issued in an
    ``MoE`` module's forward. :meth:`attributing` marks the regions."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.local_region_flops = 0
        self.collectives: dict[str, dict] = {}
        self.moe_collectives: dict[str, dict] = {}
        self.depth = {"moe": 0, "local": 0}

    @contextlib.contextmanager
    def attributing(self, model):
        """Hooks on ``model``'s ``MoE`` modules that mark their forward,
        and ``moe.moe_ffn`` wrapped to mark the local-shard region (the
        DTensor form calls it on local tensors), for the duration."""
        def enter(region):
            def hook(*_):
                self.depth[region] += 1
            return hook

        def leave(region):
            def hook(*_):
                self.depth[region] -= 1
            return hook

        hooks = []
        for m in model.modules():
            if isinstance(m, moe_mod.MoE):
                # always_call: a checkpoint's recompute stops a forward
                # early by raising
                hooks += [m.register_forward_pre_hook(enter("moe")),
                          m.register_forward_hook(leave("moe"),
                                                  always_call=True)]
        ffn = moe_mod.moe_ffn

        def local_ffn(*args, **kwargs):
            self.depth["local"] += 1
            try:
                return ffn(*args, **kwargs)
            finally:
                self.depth["local"] -= 1

        moe_mod.moe_ffn = local_ffn
        try:
            yield self
        finally:
            moe_mod.moe_ffn = ffn
            for h in hooks:
                h.remove()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        kind = COLLECTIVES.get(packet.__name__)
        if kind is not None and "c10d" in func.namespace:
            outs = out if isinstance(out, (list, tuple)) else [out]
            tallies = [self.collectives]
            if self.depth["moe"]:
                tallies.append(self.moe_collectives)
            for tally in tallies:
                rec = tally.setdefault(kind, {"count": 0, "bytes": 0})
                rec["count"] += 1
                rec["bytes"] += sum(_bytes(t) for t in outs)
        elif packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            if self.depth["local"]:
                self.local_region_flops += n
        return out


def _pointwise_rule(*args):
    """Every tensor argument and the output split alike, or replicated."""
    from torch.distributed.tensor import Replicate, Shard

    ndim = args[0].ndim
    tensors = [a is not None and hasattr(a, "ndim") for a in args]
    return [([pl], [pl if t else None for t in tensors])
            for pl in [Replicate()] + [Shard(d) for d in range(ndim)]]


def register_rules() -> None:
    """DTensor sharding rules for the ATen ops the models reach that
    DTensor has none for (the sLSTM's log-sigmoid backward)."""
    from torch.distributed.tensor.experimental import register_sharding

    register_sharding(torch.ops.aten.log_sigmoid_backward.default)(
        _pointwise_rule)


def _distribute(tensors: dict, specs: dict, mesh) -> dict:
    from torch.distributed.tensor import distribute_tensor

    return {k: distribute_tensor(t, mesh,
                                 shard_rules.placements(specs[k], mesh))
            for k, t in tensors.items()}


def _local_bytes(tree) -> int:
    """Bytes of the local shards of every DTensor in ``tree``."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return _bytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return _bytes(tree)
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    return 0


def _distribute_cache(cache, specs, mesh):
    """``cache`` (meta tensors, host ints) with each tensor distributed by
    the matching spec of ``specs`` (same structure)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(cache, torch.Tensor):
        return distribute_tensor(cache, mesh,
                                 shard_rules.placements(specs, mesh))
    if isinstance(cache, dict):
        return {k: _distribute_cache(v, specs[k], mesh)
                for k, v in cache.items()}
    if isinstance(cache, tuple) and hasattr(cache, "_fields"):
        return type(cache)(*(_distribute_cache(v, s, mesh)
                             for v, s in zip(cache, specs)))
    if isinstance(cache, (list, tuple)):
        return type(cache)(_distribute_cache(v, s, mesh)
                           for v, s in zip(cache, specs))
    return cache


def _two_dim(mesh, dp):
    """A ("pod", "data", "model") mesh as its 2-D equivalent: "pod" and
    "data" merged, pod major, into one "data" axis over the same ranks,
    so every tensor splits as on the 3-D mesh (a dim over ("pod",
    "data") is split major axis first either way). DTensor plans
    redistributions on a 3-D mesh by a graph search that takes minutes a
    layer; on the 2-D one it does not."""
    from torch.distributed.device_mesh import DeviceMesh

    if mesh.mesh_dim_names != ("pod", "data", "model"):
        return mesh, dp
    ranks = mesh.mesh.reshape(-1, mesh.mesh.shape[-1])
    return DeviceMesh(device_type(), ranks,
                      mesh_dim_names=("data", "model")), ("data",)


def _analyze_one(cfg, shape, mesh, dp, hp, *, options: dict | None = None
                 ) -> dict:
    """Place and run one step on ``mesh``; return its record."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    opt = {**DEFAULT_OPTIONS, **(options or {})}
    world = int(np.prod(mesh.mesh.shape))
    mesh_shape = dict(zip(mesh.mesh_dim_names, list(mesh.mesh.shape)))
    mesh, dp = _two_dim(mesh, dp)
    zero3 = cfg.moe is not None
    ctx = ShardingCtx(mesh=mesh, data_axes=dp, zero3_moe=zero3)
    model = build_model(cfg, ctx, device="meta")
    p_specs = shard_rules.params_shardings(
        model, cfg, mesh, dp if opt["fsdp_params"] else None,
        zero3_moe=zero3, embed_mode=opt["embed_mode"],
        rglru_row_parallel=opt["rglru_row_parallel"])
    meta_params = {k: v.detach() for k, v in model.named_parameters()}
    params = _distribute(meta_params, p_specs, mesh)
    rec = {"n_chips": world, "kind": shape.kind, "mesh": mesh_shape,
           "run_mesh": dict(zip(mesh.mesh_dim_names,
                                list(mesh.mesh.shape))),
           "device_type": device_type(), "plan": "dtensor",
           "param_bytes_per_rank": _local_bytes(params)}

    if shape.kind in ("train", "prefill"):
        batch = batch_spec(cfg, shape.global_batch, shape.seq_len, "train")
        b_specs = shard_rules.batch_shardings(cfg, mesh, dp, "train")
        batch = _distribute(batch, b_specs, mesh)
        args = {"batch": _local_bytes(batch)}
        if shape.kind == "train":
            kw = {} if cfg.encoder_layers else {"ce_impl": opt["ce_impl"]}
            step = make_train_step(model, hp, **kw)
            kappa = torch.tensor(hp.kappa, dtype=torch.float32,
                                 device="meta")
            state = TrainState(
                x=params, z={k: torch.zeros_like(v)
                             for k, v in params.items()},
                y=params, kappa=kappa)
            args["state"] = _local_bytes(state)

            def run():
                return step(state, batch)
        else:
            model.load_state_dict(params, assign=True)
            args["params"] = rec["param_bytes_per_rank"]
            kw = {} if cfg.encoder_layers else {"ce_impl": opt["ce_impl"]}

            def run():
                with torch.no_grad():
                    return model.loss(batch, **kw)
    else:
        b, max_len = shape.global_batch, shape.seq_len
        tokens = batch_spec(cfg, b, max_len, "decode")
        t_specs = shard_rules.batch_shardings(cfg, mesh, dp, "decode",
                                              batch=b)
        tokens = _distribute(tokens, t_specs, mesh)["tokens"]
        if cfg.encoder_layers:
            project = opt["whisper_cross_kv"]
            enc = torch.empty(b, cfg.encoder_seq, cfg.d_model,
                              dtype=meta_params["embed"].dtype, device="meta")
            cache = model.init_cache(b, max_len, enc, project=project)
            c_specs = shard_rules.whisper_cache_shardings(
                model, cfg, mesh, dp, b, max_len, project=project)
        else:
            cache = model.init_cache(b, max_len)
            c_specs = shard_rules.cache_shardings(model, cfg, mesh, dp, b,
                                                  max_len)
        cache = _distribute_cache(cache, c_specs, mesh)
        model.load_state_dict(params, assign=True)
        args = {"params": rec["param_bytes_per_rank"],
                "batch": _local_bytes(tokens), "cache": _local_bytes(cache)}

        def run():
            # make_serve_step's decode and argmax; the argmax reads the
            # logits gathered over the vocab (DTensor's argmax over a
            # split dim gathers through a path the fake group cannot run)
            with torch.no_grad():
                logits, new = model.decode_step(cache, tokens)
                return logits.full_tensor().argmax(-1, keepdim=True), new

    args["total"] = sum(args.values())
    rec["argument_bytes_per_rank"] = args
    counter = RankCounter()
    t0 = time.perf_counter()
    with implicit_replication(), CommDebugMode() as comm, \
            counter.attributing(model), counter, \
            FlopCounterMode(display=False) as flops:
        run()
    rec["seconds"] = time.perf_counter() - t0
    rec["flops"] = float(flops.get_total_flops()
                         + (world - 1) * counter.local_region_flops)
    rec["flops_per_rank"] = float(counter.flops)
    rec["collectives"] = counter.collectives
    rec["moe_collectives"] = counter.moe_collectives
    rec["comm_counts"] = {str(k): int(v)
                          for k, v in comm.get_comm_counts().items()}
    rec["temp_bytes_per_rank"] = None
    rec["peak_rss_bytes"] = peak_rss_bytes()
    rec["cuda_initialized"] = torch.cuda.is_initialized()
    return rec


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            hp: RWSADMMHparams | None = None,
            options: dict | None = None) -> dict:
    """One (arch × shape × mesh) on the default group (a fake one of 256
    or 512 ranks from :func:`main`). ``options`` selects the reference's
    variants (``DEFAULT_OPTIONS``)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    hp = hp or RWSADMMHparams(beta=10.0)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = _analyze_one(cfg, shape, mesh, mesh_data_axes(mesh), hp,
                       options=options)
    rec.update({
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "options": {**DEFAULT_OPTIONS, **(options or {})},
    })
    return rec


def combos(arch: str | None, shape: str | None, all_: bool,
           multi_pod: bool) -> list[tuple[str, str, bool]]:
    """The (arch, shape, multi_pod) runs the flags ask for."""
    if all_:
        return [(a, s, multi_pod) for a in ALL_ARCHS for s in INPUT_SHAPES]
    if not (arch and shape):
        raise SystemExit("give --arch and --shape, or --all")
    return [(arch, shape, multi_pod)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if not dist.is_initialized():
        fake_group(512 if args.multi_pod else 256)
    register_rules()
    failed = 0
    for arch, shape, mp in combos(args.arch, args.shape, args.all,
                                  args.multi_pod):
        if shape == "long_500k" and arch not in LONG_OK:
            print(f"SKIP {arch} × {shape}: full attention")
            continue
        tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"CACHED {tag}")
            continue
        print(f"RUN {tag} ...", flush=True)
        try:
            rec = run_one(arch, shape, multi_pod=mp)
            rec["status"] = "ok"
        except Exception as e:  # noqa: BLE001  (recorded, and the exit
            failed += 1         # code says it)
            rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"  ERROR: {rec['error'][:200]}")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        if rec["status"] == "ok":
            coll = {k: v["count"] for k, v in rec["collectives"].items()}
            print(f"  ok: flops={rec['flops']:.3e} per rank="
                  f"{rec['flops_per_rank']:.3e} params/rank="
                  f"{rec['param_bytes_per_rank']} coll={coll} "
                  f"{rec['seconds']:.1f}s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
