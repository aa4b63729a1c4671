"""Carry weights between the reference's param dicts and the port.

The reference keeps a model's params as a nested dict of arrays
(``{"conv1": {"w": HWIO, "b": ...}, "fc": {"w": (n_in, n_out), ...}}``).
The port's modules use the same shapes under the names ``conv1.w`` etc.,
and the RWSADMM state holds them flat in ``core/tree.py`` layout order.
These helpers take any array-likes (numpy, or the reference's arrays via
``np.asarray``) and return numpy on the way back, so neither package has
to import the other.

The walker fleet uses them unchanged: it starts from the same flat
``(P,)`` params (``FleetRWSADMMTrainer.init_state(params=...)``), and its
``(K, P)`` token stack is that vector repeated per walker.
``baseline_state_from_reference`` carries a whole baseline trainer's
state over, so both packages start a round from the same weights.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.tree import ParamLayout


def _walk(tree: Mapping, prefix: str = ""):
    for key in sorted(tree):
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(tree[key], Mapping):
            yield from _walk(tree[key], path)
        else:
            yield path, tree[key]


def state_from_reference(ref_params: Mapping, device=None
                         ) -> dict[str, torch.Tensor]:
    """Nested reference dict → ``{"conv1.w": tensor, ...}`` (fp32)."""
    return {path: torch.as_tensor(
                np.array(leaf, np.float32), device=device)
            for path, leaf in _walk(ref_params)}


def state_to_reference(state: Mapping[str, torch.Tensor]
                       ) -> dict[str, dict]:
    """``{"conv1.w": tensor, ...}`` → nested dict of numpy arrays."""
    out: dict = {}
    for name, t in state.items():
        node = out
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy()
    return out


def flat_from_reference(ref_params: Mapping, layout: ParamLayout,
                        device=None) -> torch.Tensor:
    """Nested reference dict → flat ``(P,)`` vector in layout order, equal
    to ``repro.core.tree.flatten`` of the same params."""
    return layout.flatten(state_from_reference(ref_params, device))


def flat_to_reference(flat: torch.Tensor, layout: ParamLayout
                      ) -> dict[str, dict]:
    """Flat ``(P,)`` vector → nested dict of numpy arrays."""
    return state_to_reference(layout.views(flat))


def _flat_rows(tree: Mapping, batch_dims: int, device=None) -> torch.Tensor:
    """Nested dict of leaves with ``batch_dims`` leading axes → one
    ``(*lead, P)`` fp32 tensor in layout order (``_walk``'s sorted keys
    are the layout's order)."""
    parts = []
    for _, leaf in _walk(tree):
        arr = np.asarray(leaf, np.float32)
        parts.append(arr.reshape(arr.shape[:batch_dims] + (-1,)))
    return torch.as_tensor(np.concatenate(parts, axis=-1), device=device)


def baseline_state_from_reference(name: str, state, device=None):
    """A reference baseline's state (its NamedTuple with array-like
    leaves) → the port's flat state of the same name: ``w`` ``(P,)`` and,
    for Ditto and APFL, ``v`` ``(n, P)``; for Walkman the clients' x and
    z ``(n, P)``, the token y ``(P,)`` and the round."""
    from .baselines import apfl, ditto, fedavg, perfedavg, pfedme
    from .baselines.walkman_trainer import WalkmanState
    from .core.walkman import WalkmanClientState

    if name == "walkman":
        return WalkmanState(
            clients=WalkmanClientState(
                x=_flat_rows(state.clients.x, 1, device),
                z=_flat_rows(state.clients.z, 1, device)),
            y=_flat_rows(state.y, 0, device),
            round=torch.tensor(int(np.asarray(state.round)),
                               dtype=torch.int32, device=device))
    states = {"fedavg": fedavg.FedAvgState,
              "perfedavg": perfedavg.PerFedAvgState,
              "pfedme": pfedme.PFedMeState, "ditto": ditto.DittoState,
              "apfl": apfl.APFLState}
    fields = {"w": _flat_rows(state.w, 0, device)}
    if name in ("ditto", "apfl"):
        fields["v"] = _flat_rows(state.v, 1, device)
    return states[name](**fields)


def load_reference(module: torch.nn.Module, ref_params: Mapping) -> None:
    """Copy a reference param dict into a module's parameters."""
    state = state_from_reference(ref_params)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if tuple(state[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference shape "
                                 f"{tuple(state[name].shape)}, module "
                                 f"{tuple(p.shape)}")
            p.copy_(state[name])


# ------------------------------------------------------------- LM ---------
# The reference LM's params: {"embed", "final_norm": {"scale"}, "layers":
# tuple over pattern index gi of dicts whose leaves stack the pattern's
# repeats on a leading axis} and, untied, "head"; a vision stub's
# "projector" (d, d); a rope-less attention stack's "pos_embed" (max_pos,
# d); a qkv bias rides in each attention layer's "mix" as "bq", "bk",
# "bv". The port's LM names layer l = r·len(pattern) + gi as
# "layers.{l}.<path>". Leaves keep their own dtypes: in a bf16 model
# RG-LRU's "lam" and the xLSTM's "w_if" and "b_gates" stay fp32.
#
# The reference EncDecLM's params: {"embed", "dec_pos", "enc_norm",
# "final_norm", "enc_layers", "dec_layers"}, each layer stack's leaves
# with the layer on a leading axis; the port names them
# "enc_layers.{l}.<path>" and "dec_layers.{l}.<path>".

#: the reference's top-level leaves (and single-dict nodes) a model may
#: hold, carried over by name
_TOP = ("embed", "head", "projector", "pos_embed", "dec_pos", "final_norm",
        "enc_norm")


def _leaf_to_torch(leaf, device=None) -> torch.Tensor:
    """An array-like as a tensor of the same dtype (bfloat16 through fp32,
    which holds it exactly)."""
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.as_tensor(np.array(arr), device=device)


def _top_state(ref_params: Mapping, device=None) -> dict[str, torch.Tensor]:
    state = {}
    for key in _TOP:
        if key not in ref_params:
            continue
        node = ref_params[key]
        if isinstance(node, Mapping):
            for path, leaf in _walk(node, key):
                state[path] = _leaf_to_torch(leaf, device)
        else:
            state[key] = _leaf_to_torch(node, device)
    return state


def _unstack(prefix: str, stacks, layer_of, device=None) -> dict:
    """Each stack (a dict of leaves with the repeat on a leading axis) of
    ``stacks`` → ``{prefix.{layer_of(i, r)}.<path>: leaf[r]}``."""
    state = {}
    for i, group in enumerate(stacks):
        for path, leaf in _walk(group):
            stacked = _leaf_to_torch(leaf, device)
            for r in range(stacked.shape[0]):
                state[f"{prefix}.{layer_of(i, r)}.{path}"] = stacked[r].clone()
    return state


def lm_state_from_reference(ref_params: Mapping, cfg, device=None
                            ) -> dict[str, torch.Tensor]:
    """Reference ``LM`` params (nested dict, array-like leaves) → the
    port ``LM``'s ``state_dict``, each leaf in its own dtype."""
    g = len(cfg.layer_pattern)
    return _top_state(ref_params, device) | _unstack(
        "layers", ref_params["layers"], lambda gi, r: r * g + gi, device)


def encdec_state_from_reference(ref_params: Mapping, device=None
                                ) -> dict[str, torch.Tensor]:
    """Reference ``EncDecLM`` params → the port ``EncDecLM``'s
    ``state_dict``, each leaf in its own dtype."""
    state = _top_state(ref_params, device)
    for stack in ("enc_layers", "dec_layers"):
        state |= _unstack(stack, [ref_params[stack]], lambda _, r: r, device)
    return state


def _load_state(model: torch.nn.Module, state: dict) -> None:
    """Copy ``state`` into the model's parameters, checking that both hold
    the same names and shapes."""
    own = dict(model.named_parameters())
    if set(state) != set(own):
        raise ValueError(f"reference and module names differ: only in the "
                         f"reference {sorted(set(state) - set(own))}, only "
                         f"in the module {sorted(set(own) - set(state))}")
    with torch.no_grad():
        for name, p in own.items():
            if tuple(state[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference shape "
                                 f"{tuple(state[name].shape)}, module "
                                 f"{tuple(p.shape)}")
            p.copy_(state[name])


def load_lm_reference(model: torch.nn.Module, ref_params: Mapping) -> None:
    """Copy reference ``LM`` params into a port ``LM``, checking that both
    hold the same names and shapes."""
    _load_state(model, lm_state_from_reference(ref_params, model.cfg))


def load_encdec_reference(model: torch.nn.Module,
                          ref_params: Mapping) -> None:
    """Copy reference ``EncDecLM`` params into a port ``EncDecLM``,
    checking that both hold the same names and shapes."""
    _load_state(model, encdec_state_from_reference(ref_params))


def reference_tree(model: torch.nn.Module,
                   params: Mapping[str, torch.Tensor] | None = None) -> dict:
    """The model's parameters (detached), or ``params`` keyed by its
    parameter names (a train state's x, z or y), in the reference's param
    tree: the inverse of ``lm_state_from_reference`` or
    ``encdec_state_from_reference``, with each layer stack's leaves
    stacked on a leading axis."""
    state = {k: v.detach() for k, v in (
        model.named_parameters() if params is None else params.items())}
    tree: dict = {}
    for name, t in state.items():
        if name.split(".")[0] in _TOP:
            node = tree
            *parents, leaf = name.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = t

    def stacked(prefix: str, layers: list[int]) -> dict:
        paths = [n.split(".", 2)[2] for n in state
                 if n.startswith(f"{prefix}.{layers[0]}.")]
        out: dict = {}
        for path in paths:
            node = out
            *parents, leaf = path.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = torch.stack([state[f"{prefix}.{l}.{path}"]
                                      for l in layers])
        return out

    if hasattr(model, "enc_layers"):
        tree["enc_layers"] = stacked("enc_layers",
                                     list(range(len(model.enc_layers))))
        tree["dec_layers"] = stacked("dec_layers",
                                     list(range(len(model.dec_layers))))
    else:
        g = len(model.cfg.layer_pattern)
        reps = model.cfg.pattern_repeats
        tree["layers"] = tuple(stacked("layers", [r * g + gi
                                                  for r in range(reps)])
                               for gi in range(g))
    return tree


def load_reference_tree(model: torch.nn.Module, tree: Mapping) -> None:
    """Copy params in the reference's tree (``reference_tree``'s layout,
    e.g. a checkpoint the reference wrote) into the model."""
    if hasattr(model, "enc_layers"):
        load_encdec_reference(model, tree)
    else:
        load_lm_reference(model, tree)
