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
# repeats on a leading axis} and, untied, "head"; a qkv bias rides in
# each attention layer's "mix" as "bq", "bk", "bv". The port's LM names layer
# l = r·len(pattern) + gi as "layers.{l}.<path>". Leaves keep their own
# dtypes: in a bf16 model RG-LRU's "lam" and the xLSTM's "w_if" and
# "b_gates" stay fp32.

def _leaf_to_torch(leaf, device=None) -> torch.Tensor:
    """An array-like as a tensor of the same dtype (bfloat16 through fp32,
    which holds it exactly)."""
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.as_tensor(np.array(arr), device=device)


def lm_state_from_reference(ref_params: Mapping, cfg, device=None
                            ) -> dict[str, torch.Tensor]:
    """Reference ``LM`` params (nested dict, array-like leaves) → the
    port ``LM``'s ``state_dict``, each leaf in its own dtype."""
    g = len(cfg.layer_pattern)
    state = {"embed": _leaf_to_torch(ref_params["embed"], device)}
    if "head" in ref_params:     # an untied output head (d, vocab)
        state["head"] = _leaf_to_torch(ref_params["head"], device)
    for path, leaf in _walk(ref_params["final_norm"], "final_norm"):
        state[path] = _leaf_to_torch(leaf, device)
    for gi, group in enumerate(ref_params["layers"]):
        for path, leaf in _walk(group):
            stacked = _leaf_to_torch(leaf, device)
            for r in range(cfg.pattern_repeats):
                state[f"layers.{r * g + gi}.{path}"] = stacked[r].clone()
    return state


def load_lm_reference(model: torch.nn.Module, ref_params: Mapping) -> None:
    """Copy reference ``LM`` params into a port ``LM``, checking that both
    hold the same names and shapes."""
    state = lm_state_from_reference(ref_params, model.cfg)
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
