"""Static routing baselines (paper §5.1 + discussion).

* ``UniformRouter`` — the paper's baseline: fixed (0.33, 0.33, 0.34),
  capacity-agnostic, "commonly used in production systems (Kubernetes
  Services, NGINX upstream)".
* ``CapacityRouter`` — the stronger capacity-aware comparison the paper
  mentions (weights ∝ CPU limits, e.g. 0.15/0.23/0.62 for the 2:3:8 ratio);
  requires exactly the prior knowledge AIF-Router aims to eliminate.
* ``RoundRobinRouter`` — deterministic cycling (expressed as weights by
  rotating a one-hot; over a 1 s window at 50 RPS this is equivalent to
  uniform, included for completeness of the static family).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import policies


class UniformRouter:
    """Fixed uniform weights — the paper's baseline strategy.

    Defaults to the paper's 3-tier split (0.33, 0.33, 0.34); for deeper
    topologies pass ``n_tiers`` (two-decimal rounding, remainder on the
    heaviest tier, matching the generated balanced policy).
    """

    name = "uniform"

    def __init__(self, n_tiers: int = 3):
        self.weights = policies.balanced_weights(n_tiers)

    def __call__(self, snapshot) -> np.ndarray:
        return self.weights


class CapacityRouter:
    """Weights proportional to known tier capacities (cores / service time)."""

    name = "capacity"

    def __init__(self, weights=(0.15, 0.23, 0.62)):
        w = np.asarray(weights, dtype=np.float64)
        self.weights = w / w.sum()

    def __call__(self, snapshot) -> np.ndarray:
        return self.weights


class RoundRobinRouter:
    """Cycles a one-hot weight across tiers every control window."""

    name = "round_robin"

    def __init__(self, n_tiers: int = 3):
        self.n_tiers = n_tiers
        self.k = 0

    def __call__(self, snapshot) -> np.ndarray:
        w = np.zeros(self.n_tiers)
        w[self.k % self.n_tiers] = 1.0
        self.k += 1
        return w
