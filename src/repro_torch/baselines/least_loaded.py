"""Least-loaded (join-shortest-queue) adaptive baseline.

Uses the per-tier queue depths + liveness from the observability layer and
sends traffic inversely proportional to (queue depth + busy estimate).  This
is the classic strong heuristic AIF-Router should be compared against; it
*does* require per-tier queue visibility, which the paper's router denies
itself (it must infer backend state through A).
"""
from __future__ import annotations

import numpy as np


class LeastLoadedRouter:
    name = "least_loaded"

    def __init__(self, softness: float = 1.0):
        self.softness = softness

    def __call__(self, snapshot) -> np.ndarray:
        load = snapshot.tier_queue_depth + 1.0
        w = 1.0 / load**self.softness
        w = w * snapshot.tier_up            # never route to a down pod
        if w.sum() <= 0:
            w = np.ones_like(w)
        return w / w.sum()
