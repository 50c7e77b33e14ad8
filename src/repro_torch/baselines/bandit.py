"""Multi-armed-bandit baselines (paper §2: Thompson sampling / UCB).

These are the "lightweight RL" alternatives the related-work section
discusses: faster to converge than deep RL but needing explicit reward
engineering.  Arms = the same generated routing-policy set as AIF-Router
(20 policies for the paper topology), so the comparison isolates the
*decision rule* (EFE vs. bandit) rather than the action space.

Reward: ``r = success_rate − λ · normalized_p95`` per control window,
attributed to the arm that was active — exactly the hand-crafted reward
engineering Active Inference avoids.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import policies
from repro_torch.core.topology import Topology, default_topology


class ThompsonRouter:
    """Gaussian Thompson sampling over the topology's discrete policies."""

    name = "thompson"

    def __init__(self, seed: int = 0, latency_scale_s: float = 5.0,
                 latency_weight: float = 0.5, obs_noise: float = 0.25,
                 topology: Topology | None = None):
        self.rng = np.random.default_rng(seed)
        self.table = policies.generate_policy_table(
            topology or default_topology())
        n = self.table.shape[0]
        self.mu = np.zeros(n)
        self.var = np.ones(n)           # prior N(0, 1) per arm
        self.obs_noise = obs_noise
        self.latency_scale_s = latency_scale_s
        self.latency_weight = latency_weight
        self.active_arm = 0

    def _reward(self, snapshot) -> float:
        return (1.0 - snapshot.error_rate) - self.latency_weight * min(
            snapshot.p95_latency_s / self.latency_scale_s, 2.0)

    def __call__(self, snapshot) -> np.ndarray:
        # credit the previous window to the arm that produced it
        r = self._reward(snapshot)
        k = self.active_arm
        prec = 1.0 / self.var[k] + 1.0 / self.obs_noise
        self.mu[k] = (self.mu[k] / self.var[k] + r / self.obs_noise) / prec
        self.var[k] = 1.0 / prec
        # sample and play
        draws = self.rng.normal(self.mu, np.sqrt(self.var))
        self.active_arm = int(np.argmax(draws))
        return self.table[self.active_arm]


class UcbRouter:
    """UCB1 over the topology's discrete policies."""

    name = "ucb"

    def __init__(self, c: float = 1.0, latency_scale_s: float = 5.0,
                 latency_weight: float = 0.5,
                 topology: Topology | None = None):
        self.table = policies.generate_policy_table(
            topology or default_topology())
        n = self.table.shape[0]
        self.counts = np.zeros(n)
        self.sums = np.zeros(n)
        self.c = c
        self.latency_scale_s = latency_scale_s
        self.latency_weight = latency_weight
        self.active_arm = 0
        self.t = 0

    def _reward(self, snapshot) -> float:
        return (1.0 - snapshot.error_rate) - self.latency_weight * min(
            snapshot.p95_latency_s / self.latency_scale_s, 2.0)

    def __call__(self, snapshot) -> np.ndarray:
        self.t += 1
        k = self.active_arm
        self.counts[k] += 1
        self.sums[k] += self._reward(snapshot)
        means = self.sums / np.maximum(self.counts, 1)
        bonus = self.c * np.sqrt(np.log(self.t + 1) / np.maximum(
            self.counts, 1e-9))
        bonus[self.counts == 0] = 1e9    # force exploration of unplayed arms
        self.active_arm = int(np.argmax(means + bonus))
        return self.table[self.active_arm]
