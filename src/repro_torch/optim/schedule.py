"""Learning-rate schedules (the JAX package's ``optim/schedule.py``): each
maps a step count (a 0-d integer tensor, or an int) to a 0-d fp32 tensor
on the count's device."""
from __future__ import annotations

import math

import torch


def _count(step) -> torch.Tensor:
    return torch.as_tensor(step)


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32,
                                     device=_count(step).device)


def step_decay(value: float, decay: float = 0.99, every: int = 1):
    """value · decay^⌊step / every⌋."""
    def fn(step):
        step = _count(step)
        k = torch.div(step, every, rounding_mode="floor").float()
        return torch.tensor(value, dtype=torch.float32,
                            device=step.device) * decay ** k
    return fn


def cosine(value: float, total_steps: int, final_frac: float = 0.1):
    """value · (final_frac + (1 − final_frac) · ½(1 + cos πt)), t =
    step / total_steps clipped to [0, 1]."""
    def fn(step):
        t = torch.clamp(_count(step).float() / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return value * (final_frac + (1.0 - final_frac) * cos)
    return fn
