"""Client availability: duty-cycled radios and stragglers.

Host-side control plane. Each round yields an (n,) bool mask; offline
clients are dropped from zones before subsampling (the visited client
i_k always participates — the server is physically at its location).

  * Duty cycling: client i is awake iff
    ((round + phase_i) mod period) < duty_cycle · period, with phases
    drawn once at reset — staggered sleep schedules, the standard
    sensor-network energy policy.
  * Stragglers: a fixed ``straggler_frac`` subset additionally misses
    each round with probability ``straggler_p`` (slow compute, drained
    battery) — an independent Bernoulli draw per straggler per round.

Port of ``repro/scenarios/churn.py``: the same draws in the same order.
"""
from __future__ import annotations

import numpy as np

from .config import ChurnConfig


class ChurnModel:
    def __init__(self, n: int, cfg: ChurnConfig):
        self.n = n
        self.cfg = cfg

    def reset(self, rng: np.random.Generator) -> np.ndarray:
        self.phase = rng.integers(self.cfg.period, size=self.n)
        k = int(round(self.cfg.straggler_frac * self.n))
        self.stragglers = np.zeros(self.n, dtype=bool)
        if k > 0:
            self.stragglers[
                rng.choice(self.n, size=k, replace=False)] = True
        return self._avail(0, rng)

    def step(self, round_idx: int, rng: np.random.Generator) -> np.ndarray:
        return self._avail(round_idx, rng)

    def rollout(self, start_round: int, rounds: int,
                rng: np.random.Generator) -> np.ndarray:
        """(rounds, n) availability masks for rounds ``start_round ..
        start_round + rounds - 1`` in one vectorized pass. The straggler
        tensor is one (rounds, n) draw — bit-identical to ``rounds``
        sequential per-round draws, so batched and stepped schedules
        replay each other exactly."""
        c = self.cfg
        rs = np.arange(start_round, start_round + rounds)
        on = ((rs[:, None] + self.phase[None, :]) % c.period) \
            < c.duty_cycle * c.period
        miss = rng.uniform(size=(rounds, self.n)) < c.straggler_p
        return on & ~(self.stragglers[None, :] & miss)

    def _avail(self, round_idx: int,
               rng: np.random.Generator) -> np.ndarray:
        c = self.cfg
        on = ((round_idx + self.phase) % c.period) \
            < c.duty_cycle * c.period
        # Fixed-shape draw (all n) so RNG consumption is independent of
        # the straggler set — replays stay aligned across configs.
        miss = rng.uniform(size=self.n) < c.straggler_p
        return on & ~(self.stragglers & miss)
