"""Multi-tier serving: AIF-Router as the control plane over model tiers
(the port of ``repro/serving/multitier.py``; host numpy, as there).

This is the paper's deployment pattern transplanted to the datacenter: the
K heterogeneous tiers are *model variants* (e.g. small / medium / large) of
one family, each behind its own :class:`ServingEngine`, and the Active
Inference router splits incoming traffic across them from aggregated
observations only — no prior knowledge of tier capacity, exactly the paper's
research question.  Any tier count works: pair an
:class:`~repro_torch.envsim.routers.AifRouter` whose topology has K tiers with K
``TierRuntime`` entries.

Time is discretized into control ticks (1 tick ≡ the paper's 1-second fast
loop).  Per tick: requests arrive (Poisson), get dispatched by the current
routing weights, engines run their decode waves (capacity heterogeneity =
steps-per-tick × slots), and the router observes
(P95 latency, RPS, queue depth, SLO-violation rate) + per-tier utilization.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.envsim.simulator import MetricsSnapshot
from repro_torch.serving.engine import Request, ServingEngine


@dataclasses.dataclass
class TierRuntime:
    engine: ServingEngine
    steps_per_tick: int = 1


@dataclasses.dataclass
class TickStats:
    arrivals: int
    completed: int
    latencies: list
    queue_depth: int
    violations: int


class MultiTierServer:
    def __init__(self, tiers: Sequence[TierRuntime],
                 router: Callable[[MetricsSnapshot], np.ndarray],
                 slo_ticks: int = 8, seed: int = 0):
        self.tiers = list(tiers)
        self.router = router
        self.slo_ticks = slo_ticks
        self.rng = np.random.default_rng(seed)
        self.tick = 0
        self.next_id = 0
        self.submit_tick: dict[int, int] = {}
        self.tier_of: dict[int, int] = {}
        self.latencies: list[float] = []
        self.violations = 0
        self.completed = 0
        self.tier_completed = np.zeros(len(self.tiers), dtype=np.int64)
        self.tier_routed = np.zeros(len(self.tiers), dtype=np.int64)
        self.weights_trace: list[np.ndarray] = []
        self._recent: list[tuple[int, float]] = []   # (tick, latency)

    # ------------------------------------------------------------- metrics
    def _snapshot(self) -> MetricsSnapshot:
        horizon = 30
        recent = [l for (t, l) in self._recent if t >= self.tick - horizon]
        p95 = float(np.percentile(recent, 95)) if recent else 0.0
        viol = (sum(1 for l in recent if l > self.slo_ticks)
                / max(len(recent), 1))
        rps = len([t for (t, _) in self._recent
                   if t >= self.tick - 5]) / 5.0
        return MetricsSnapshot(
            t=float(self.tick),
            p95_latency_s=p95,
            rps=rps,
            queue_depth=float(sum(t.engine.queue_depth for t in self.tiers)),
            error_rate=float(viol),
            tier_utilization=np.asarray(
                [t.engine.utilization() for t in self.tiers]),
            tier_queue_depth=np.asarray(
                [float(t.engine.queue_depth) for t in self.tiers]),
            tier_up=np.ones(len(self.tiers), dtype=bool),
        )

    # ----------------------------------------------------------------- run
    def run(self, n_ticks: int, arrival_rate: float,
            prompt_len: int = 16, max_new_tokens: int = 8,
            vocab: int | None = None) -> dict:
        for _ in range(n_ticks):
            snap = self._snapshot()
            w = np.asarray(self.router(snap), dtype=np.float64)
            w = np.clip(w, 0, None)
            w = w / max(w.sum(), 1e-12)
            self.weights_trace.append(w)

            n_new = self.rng.poisson(arrival_rate)
            for _ in range(n_new):
                tier = int(self.rng.choice(len(self.tiers), p=w))
                v = vocab or self.tiers[tier].engine.cfg.vocab_size
                req = Request(id=self.next_id,
                              tokens=list(self.rng.integers(
                                  0, v, size=prompt_len)),
                              max_new_tokens=max_new_tokens)
                self.next_id += 1
                self.submit_tick[req.id] = self.tick
                self.tier_of[req.id] = tier
                self.tiers[tier].engine.submit(req)
                self.tier_routed[tier] += 1

            for ti, tier in enumerate(self.tiers):
                for _ in range(tier.steps_per_tick):
                    for req in tier.engine.step():
                        lat = self.tick - self.submit_tick[req.id] + 1
                        self.latencies.append(lat)
                        self._recent.append((self.tick, lat))
                        self.completed += 1
                        self.tier_completed[ti] += 1
                        if lat > self.slo_ticks:
                            self.violations += 1
            self.tick += 1

        lat = np.asarray(self.latencies, dtype=np.float64)
        return {
            "completed": self.completed,
            "p50_ticks": float(np.percentile(lat, 50)) if len(lat) else 0.0,
            "p95_ticks": float(np.percentile(lat, 95)) if len(lat) else 0.0,
            "slo_violation_rate": self.violations / max(self.completed, 1),
            "tier_completed": self.tier_completed.copy(),
            "tier_routed": self.tier_routed.copy(),
            "mean_weights": np.mean(self.weights_trace, axis=0),
            "late_weights": np.mean(self.weights_trace[-max(n_ticks // 4, 1):],
                                    axis=0),
        }
