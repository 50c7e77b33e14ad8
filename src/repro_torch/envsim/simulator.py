"""What a router may observe of the system it routes for (the port of the
``MetricsSnapshot`` of ``repro/envsim/simulator.py``; the event simulator
itself is ROADMAP item A11)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MetricsSnapshot:
    """What a router is allowed to observe (paper §3: observability-driven).

    Request-level metrics refresh every second; ``tier_utilization`` emulates
    the 10-second aggregated resource scrape.
    """

    t: float
    p95_latency_s: float          # sliding-window P95 of completed requests
    rps: float                    # completion throughput (short window)
    queue_depth: float            # total queued requests (all tiers)
    error_rate: float             # errors / (errors+successes), sliding window
    tier_utilization: np.ndarray  # (K,) busy-core fraction, 10 s cadence
    tier_queue_depth: np.ndarray  # (K,) per-tier queue depth (JSQ baselines)
    tier_up: np.ndarray           # (K,) bool — liveness probe
