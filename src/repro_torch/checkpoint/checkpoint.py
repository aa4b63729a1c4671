"""npz-based checkpointing of nested states (port of
``repro/checkpoint/checkpoint.py``).

Leaves are tensors (or numpy arrays) inside dicts, NamedTuples, tuples
and lists, saved under '/'-joined key paths as the reference names them
(a dict key, a NamedTuple field, a sequence index), so a trainer state
round-trips without pickling: an RWSADMM state saves as
``clients/x``, ``clients/z``, ``server/y``, ``server/kappa``,
``server/round``, ``visited`` (the port's client rows are flat ``(n, P)``
where the reference keeps a parameter pytree per variable). The token y
is itself a checkpoint: the mobile server's handoff.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch


def _leaves_with_paths(tree: Any, path: tuple = ()) -> list:
    """``[(path, leaf)]`` in the tree's order: dict keys sorted (as JAX
    orders them), NamedTuple fields and sequence items in order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves_with_paths(tree[k], path + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for name, v in zip(tree._fields, tree)
                for kv in _leaves_with_paths(v, path + (name,))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves_with_paths(v, path + (str(i),))]
    return [(path, tree)]


def _rebuild(tree: Any, leaves) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any, step: int | None = None) -> str:
    """Save ``tree`` to ``path`` (.npz); with ``step`` also a
    ``.meta.json`` beside it. Returns the path written."""
    flat = {"/".join(p): _host(leaf) for p, leaf in _leaves_with_paths(tree)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
    if step is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump({"step": step}, f)
    return path


def load_pytree(path: str, template: Any) -> Any:
    """Load into the structure of ``template`` (shapes must match). A
    tensor leaf comes back as a tensor of its template's dtype on its
    template's device; any other leaf as a numpy array of its dtype."""
    data = np.load(path)
    out = []
    for p, leaf in _leaves_with_paths(template):
        key = "/".join(p)
        arr = data[key]
        shape = tuple(leaf.shape)
        if arr.shape != shape:
            raise ValueError(
                f"checkpoint leaf {key}: shape {arr.shape} != {shape}")
        if isinstance(leaf, torch.Tensor):
            out.append(torch.from_numpy(arr).to(device=leaf.device,
                                                dtype=leaf.dtype))
        else:
            out.append(arr.astype(np.asarray(leaf).dtype))
    return _rebuild(template, iter(out))


def save_client_store(path: str, store) -> str:
    """Save a :class:`~..fl.client_store.ClientStore`'s host bookkeeping
    (slot map, LRU order, counters, spill buffer) to ``path`` (.npz). It
    pairs with the trainer state's checkpoint, which holds the packed
    x/z rows; this holds everything else the store needs to resume
    mid-run, evicted (spilled) rows included."""
    sd = store.state_dict()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in sd.items()})
    return path


def load_client_store(path: str, store) -> None:
    """Restore ``store`` (built with the same factory and capacity, and
    reset by ``init_state``) from :func:`save_client_store`'s file. The
    resident clients' data rows are drawn anew from the factory; the
    caller restores the packed x/z rows with :func:`load_pytree`."""
    with np.load(path) as data:
        store.load_state_dict({k: data[k] for k in data.files})


def restore_latest(directory: str, template: Any,
                   pattern: str = r"ckpt_(\d+)\.npz"):
    """``(tree, step)`` of the highest-step checkpoint in ``directory``,
    or ``(None, -1)``."""
    if not os.path.isdir(directory):
        return None, -1
    best, best_step = None, -1
    for fn in os.listdir(directory):
        m = re.fullmatch(pattern, fn)
        if m and int(m.group(1)) > best_step:
            best, best_step = fn, int(m.group(1))
    if best is None:
        return None, -1
    return load_pytree(os.path.join(directory, best), template), best_step
