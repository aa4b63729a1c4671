"""Differentially private RWSADMM uploads (port of
``repro/core/privacy.py``; the paper's §6 future-work item).

The only thing a client transmits is its contribution delta
Δc = c_new − c_old (Eq. 14's upload). It is clipped to an l2 ball of
radius ``clip`` and Gaussian noise of scale σ·clip is added: the
Gaussian mechanism, (ε, δ)-DP per round with respect to the client's
local dataset; over T visits the bound composes by advanced composition.
x_i and z_i never leave the client; the walking token only sees the
clipped, noised deltas.

Deltas are flat ``(..., P)`` rows in a :class:`~.tree.ParamLayout`. The
noise is drawn per leaf, as the reference draws it over its parameter
pytree: a row's key splits into one key per leaf, in layout order (the
reference's leaf order), and leaf l's noise is ``normal(key_l,
shape_l)``, flattened in place.
"""
from __future__ import annotations

import math

import torch

from . import prng
from .tree import ParamLayout


def clip_tree(t: torch.Tensor, clip: float) -> torch.Tensor:
    """Project each row of ``t`` ``(..., P)`` onto the l2 ball of radius
    ``clip`` (the norm over all its leaves). The squares are summed in
    another order than XLA sums them, so the scale agrees to rounding."""
    nrm = torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True))
    scale = torch.clamp(clip / torch.clamp(nrm, min=1e-12), max=1.0)
    return t * scale


def gaussian_noise_like(keys: torch.Tensor, layout: ParamLayout,
                        sigma: float) -> torch.Tensor:
    """N(0, σ²) noise ``(..., P)``, one key ``(..., 2)`` per row: the key
    splits into one key per leaf and each leaf draws over its own
    shape."""
    leaf_keys = prng.split(keys, len(layout.names))      # (..., L, 2)
    lead = keys.shape[:-1]
    parts = [prng.normal(leaf_keys[..., i, :], shape).reshape(*lead, -1)
             for i, shape in enumerate(layout.shapes)]
    return torch.cat(parts, dim=-1) * sigma


def privatize_delta(keys: torch.Tensor, c_new: torch.Tensor,
                    c_old: torch.Tensor, layout: ParamLayout, *,
                    clip: float, noise_multiplier: float) -> torch.Tensor:
    """The DP upload of each row: clip(Δc) + N(0, (σ·clip)²)."""
    delta = clip_tree(c_new - c_old, clip)
    return delta + gaussian_noise_like(keys, layout,
                                       noise_multiplier * clip)


def epsilon_advanced_composition(noise_multiplier: float, visits: int,
                                 delta: float = 1e-5) -> float:
    """(ε, δ) after ``visits`` Gaussian-mechanism releases (advanced
    composition; looser than RDP, with no dependency)."""
    if noise_multiplier <= 0:
        return float("inf")
    eps_step = math.sqrt(2.0 * math.log(1.25 / delta)) / noise_multiplier
    if eps_step > 50.0:   # exp() would overflow; the bound is vacuous
        return float("inf")
    return (math.sqrt(2.0 * visits * math.log(1.0 / delta)) * eps_step
            + visits * eps_step * (math.exp(eps_step) - 1.0))
