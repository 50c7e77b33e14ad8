"""Experiment harness: the paper's evaluation protocol (§5.1) in simulation
(the port of ``repro/envsim/harness.py``).

"Each strategy was tested in 3 repeated 45-minute runs"; we expose the run
count / duration as knobs (``chip_smoke.py`` uses 3 × 10-minute runs for
speed, ``tools/event_table1.py --full`` the full protocol) and report mean ± std of
success rate, P50/P95 latency and tier distribution — the columns of
Table 1.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.envsim.config import SimConfig
from repro_torch.envsim.simulator import RunResult, run_experiment


@dataclasses.dataclass
class StrategySummary:
    """Mean ± std over repeated runs (one Table 1 row)."""

    name: str
    runs: list
    success_pct_mean: float
    success_pct_std: float
    p50_ms_mean: float
    p50_ms_std: float
    p95_ms_mean: float
    p95_ms_std: float
    tier_share_mean: np.ndarray     # share of *successful* requests (Fig. 3b)
    tier_share_std: np.ndarray
    routed_share_mean: np.ndarray   # share of routed requests (Fig. 3a)
    restarts_mean: np.ndarray

    def row(self) -> str:
        ts = self.tier_share_mean * 100
        # heaviest tier first, matching the paper's Table 1 column order
        share = " ".join(f"t{i}={ts[i]:4.1f}%"
                         for i in range(len(ts) - 1, -1, -1))
        return (f"{self.name:<14} {self.success_pct_mean:6.1f}±{self.success_pct_std:4.2f}  "
                f"{self.p50_ms_mean:7.0f}±{self.p50_ms_std:<5.0f} "
                f"{self.p95_ms_mean:7.0f}±{self.p95_ms_std:<5.0f} "
                f"{share}")


def evaluate_strategy(make_router: Callable[[int], Callable],
                      name: str,
                      cfg: SimConfig,
                      duration_s: float = 2700.0,
                      n_runs: int = 3,
                      base_seed: int = 0) -> StrategySummary:
    """Run the paper's protocol: ``n_runs`` independent runs, fresh router each.

    ``make_router(seed)`` must return a fresh router instance (routers are
    stateful online learners; reusing one across runs would leak experience
    across the paper's cooldown boundary).
    """
    runs: list[RunResult] = []
    for r in range(n_runs):
        router = make_router(base_seed + 1000 * r)
        res = run_experiment(router, cfg, duration_s, seed=base_seed + 17 * r)
        runs.append(res)

    succ = np.asarray([100.0 * r.success_rate for r in runs])
    p50 = np.asarray([r.p50_ms for r in runs])
    p95 = np.asarray([r.p95_ms for r in runs])
    share = np.stack([r.tier_share_of_success() for r in runs])
    routed = np.stack([r.tier_share_routed() for r in runs])
    restarts = np.stack([r.n_restarts for r in runs])

    return StrategySummary(
        name=name,
        runs=runs,
        success_pct_mean=float(succ.mean()), success_pct_std=float(succ.std()),
        p50_ms_mean=float(p50.mean()), p50_ms_std=float(p50.std()),
        p95_ms_mean=float(p95.mean()), p95_ms_std=float(p95.std()),
        tier_share_mean=share.mean(0), tier_share_std=share.std(0),
        routed_share_mean=routed.mean(0),
        restarts_mean=restarts.mean(0).astype(np.float64),
    )


def table1(summaries: Sequence[StrategySummary]) -> str:
    """Render Table 1: 'Overall performance comparison at 50 RPS'."""
    hdr = (f"{'Strategy':<14} {'Succ.(%)':>12}  {'P50(ms)':>13} {'P95(ms)':>13} "
           f"tier distribution (of successes)")
    lines = [hdr, "-" * len(hdr)]
    lines += [s.row() for s in summaries]
    return "\n".join(lines)
