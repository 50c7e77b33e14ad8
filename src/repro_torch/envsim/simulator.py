"""Event-driven simulator of the paper's edge testbed, any tier count (the
port of ``repro/envsim/simulator.py``: host numpy, carried over as code).

Request lifecycle: Poisson (burst-modulated) arrival → routed to a tier by the
current routing weights → served by one of the tier's ``servers`` cores
(FIFO queue while all busy) → completion, or failure by one of:

  * ``timeout``   — client gives up after ``timeout_s`` (checked at dequeue
                    and at completion),
  * ``overflow``  — tier admission queue full (HTTP 503),
  * ``refused``   — tier pod is down (restarting) at arrival,
  * ``restart``   — pod restarted while the request was queued / in flight.

Pod restarts model the paper's Jetson instability: each *unstable* tier draws
a per-second hazard ``base + load·max(0, util_ema − knee)`` — restarts become
likely when the tier is driven near saturation, which is exactly how an
aggressive low-latency router amplifies failures (paper §5.2, Key Findings).

The simulator advances in 1-second *control windows*; a router policy sets the
routing weights at each window boundary from the observable metrics snapshot
(P95 latency, RPS, queue depth, error rate — plus the 10-second resource
scrape of per-tier utilizations, paper §3).

Every random draw comes from one ``np.random.default_rng(seed)``, in the
reference's order: the arrival gaps, the routing uniform, each tier's
lognormal service times and the restart draws of unstable tiers that are
up.  The event heap ties on ``(time, seq)``.  So the same router weights
give the reference's run to the bit.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch.envsim.config import SimConfig

# Event types (sorted tuple entries: (time, seq, kind, payload...)).
_ARRIVAL = 0
_COMPLETION = 1


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


@dataclasses.dataclass
class RunResult:
    """Aggregate outcome of one run (enough to regenerate Table 1 rows)."""

    n_requests: int
    n_success: int
    n_error: int
    error_breakdown: dict
    p50_ms: float
    p95_ms: float
    tier_requests: np.ndarray        # (K,) routed counts (incl. failures)
    tier_success: np.ndarray         # (K,) successful completions per tier
    n_restarts: np.ndarray           # (K,) pod restarts per tier
    weights_trace: np.ndarray        # (T, K) applied weights per window
    p95_trace: np.ndarray            # (T,) observed P95 per window
    error_trace: np.ndarray          # (T,) observed error rate per window
    action_trace: Optional[np.ndarray] = None   # router-specific diagnostics

    @property
    def success_rate(self) -> float:
        return self.n_success / max(self.n_requests, 1)

    def tier_share_of_success(self) -> np.ndarray:
        return self.tier_success / max(self.tier_success.sum(), 1)

    def tier_share_routed(self) -> np.ndarray:
        return self.tier_requests / max(self.tier_requests.sum(), 1)


class _Tier:
    """c-server FIFO queue with pod-restart instability."""

    def __init__(self, cfg, rng: np.random.Generator):
        self.cfg = cfg
        self.rng = rng
        self.busy = 0
        self.queue: deque = deque()      # (arrival_time, request_id)
        self.epoch = 0                   # bumped on restart; stale completions die
        self.down_until = -1.0
        self.n_restarts = 0
        # busy-time integration for utilization metrics
        self.busy_integral = 0.0
        self.last_t = 0.0
        # lognormal service-time parameters
        cv = cfg.service_cv
        self.sigma = math.sqrt(math.log(1.0 + cv * cv))
        self.mu = math.log(cfg.mean_service_s) - 0.5 * self.sigma**2

    def service_time(self) -> float:
        return float(self.rng.lognormal(self.mu, self.sigma))

    def is_up(self, t: float) -> bool:
        return t >= self.down_until

    def integrate(self, t: float):
        self.busy_integral += self.busy * (t - self.last_t)
        self.last_t = t

    def utilization(self, t0: float, t1: float) -> float:
        """Mean busy-core fraction over [t0, t1] (uses the busy integral)."""
        span = max(t1 - t0, 1e-9)
        return self.busy_integral / (span * self.cfg.servers)

    def reset_util_window(self, t: float):
        self.busy_integral = 0.0
        self.last_t = t


class EdgeSimulator:
    """The simulated cloud-edge continuum."""

    def __init__(self, cfg: SimConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.tiers = [_Tier(tc, self.rng) for tc in cfg.tiers]
        k = len(self.tiers)
        self.events: list = []
        self.seq = 0
        self.t = 0.0
        self.weights = np.full(k, 1.0 / k)
        # outcome accounting
        self.n_requests = 0
        self.n_success = 0
        self.errors = {"timeout": 0, "overflow": 0, "refused": 0, "restart": 0}
        self.tier_requests = np.zeros(k, dtype=np.int64)
        self.tier_success = np.zeros(k, dtype=np.int64)
        # sliding windows for router observability
        self.completions: deque = deque()   # (t_done, latency_s)
        self.arrivals: deque = deque()      # t of recent arrivals (for RPS)
        self.outcomes: deque = deque()      # (t, success: bool)
        self.all_latencies: list = []       # successful latencies (for P50/P95)
        # per-tier utilization scrape (10 s cadence)
        self.util_scrape = np.zeros(k)
        self._last_scrape_t = 0.0
        # per-window offered load per tier (for the load-shock hazard)
        self.window_tier_arrivals = np.zeros(k, dtype=np.int64)
        self.prev_tier_rps = np.zeros(k)
        self._schedule_next_arrival()

    # ------------------------------------------------------------------ events
    def _push(self, time: float, kind: int, payload):
        heapq.heappush(self.events, (time, self.seq, kind, payload))
        self.seq += 1

    def _rate_at(self, t: float) -> float:
        cfg = self.cfg
        phase = (t % cfg.burst_period_s) / cfg.burst_period_s
        factor = cfg.burst_factor if phase < cfg.burst_duty else (
            cfg.off_burst_factor())
        return cfg.rps * factor

    def _schedule_next_arrival(self):
        # Non-homogeneous Poisson via thinning-free local-rate approximation:
        # the rate is piecewise-constant on a much coarser scale (seconds)
        # than the inter-arrival gaps (~20 ms) so local-rate sampling is exact
        # enough for our purposes.
        rate = max(self._rate_at(self.t), 1e-9)
        gap = float(self.rng.exponential(1.0 / rate))
        self._push(self.t + gap, _ARRIVAL, None)

    # ------------------------------------------------------------------ tiers
    def _start_service(self, tier_idx: int, arrival_t: float):
        tier = self.tiers[tier_idx]
        tier.integrate(self.t)
        tier.busy += 1
        done = self.t + tier.service_time()
        self._push(done, _COMPLETION, (tier_idx, arrival_t, tier.epoch))

    def _route(self):
        u = self.rng.random()
        c = 0.0
        for i, w in enumerate(self.weights):
            c += w
            if u < c:
                return i
        return len(self.weights) - 1

    def _on_arrival(self):
        self._schedule_next_arrival()
        self.n_requests += 1
        self.arrivals.append(self.t)
        tier_idx = self._route()
        self.tier_requests[tier_idx] += 1
        self.window_tier_arrivals[tier_idx] += 1
        tier = self.tiers[tier_idx]
        if not tier.is_up(self.t):
            self._record_failure("refused")
            return
        if tier.busy < tier.cfg.servers:
            self._start_service(tier_idx, self.t)
        elif len(tier.queue) < tier.cfg.queue_cap:
            tier.queue.append((self.t, tier_idx))
        else:
            self._record_failure("overflow")

    def _on_completion(self, tier_idx: int, arrival_t: float, epoch: int):
        tier = self.tiers[tier_idx]
        if epoch != tier.epoch:
            return  # killed by a restart; already accounted there
        tier.integrate(self.t)
        tier.busy -= 1
        latency = self.t - arrival_t
        if latency <= self.cfg.timeout_s:
            self.n_success += 1
            self.tier_success[tier_idx] += 1
            self.completions.append((self.t, latency))
            self.outcomes.append((self.t, True))
            self.all_latencies.append(latency)
        else:
            self._record_failure("timeout")
        self._dequeue(tier_idx)

    def _dequeue(self, tier_idx: int):
        tier = self.tiers[tier_idx]
        while tier.queue and tier.busy < tier.cfg.servers:
            arrival_t, _ = tier.queue.popleft()
            if self.t - arrival_t > self.cfg.timeout_s:
                self._record_failure("timeout")
                continue
            self._start_service(tier_idx, arrival_t)

    def _record_failure(self, cause: str):
        self.errors[cause] += 1
        self.outcomes.append((self.t, False))

    # ------------------------------------------------------------- instability
    def _maybe_restart(self, window_s: float):
        tier_rps = self.window_tier_arrivals / max(window_s, 1e-9)
        rps_delta = tier_rps - self.prev_tier_rps
        self.prev_tier_rps = tier_rps
        self.window_tier_arrivals = np.zeros(len(self.tiers), dtype=np.int64)
        if not self.cfg.instability:
            return
        for i, tier in enumerate(self.tiers):
            tc = tier.cfg
            if not tc.unstable or not tier.is_up(self.t):
                continue
            util = self.util_scrape[i]
            cap_rps = tc.servers / tc.mean_service_s
            hazard = (
                tc.restart_base_hazard
                + tc.restart_load_hazard * max(0.0, util - tc.restart_util_knee)
                + tc.restart_shock_hazard * max(0.0, rps_delta[i]) / cap_rps
            )
            if self.rng.random() < 1.0 - math.exp(-hazard * window_s):
                self._trigger_restart(i)

    def _trigger_restart(self, tier_idx: int):
        tier = self.tiers[tier_idx]
        tier.n_restarts += 1
        tier.epoch += 1
        dur = self.rng.uniform(tier.cfg.restart_min_s, tier.cfg.restart_max_s)
        tier.down_until = self.t + dur
        # queued and in-flight requests die with the pod
        n_killed = len(tier.queue) + tier.busy
        for _ in range(n_killed):
            self._record_failure("restart")
        tier.queue.clear()
        tier.integrate(self.t)
        tier.busy = 0

    # ------------------------------------------------------------- observation
    def _trim_windows(self):
        t = self.t
        cfg = self.cfg
        while self.completions and self.completions[0][0] < t - cfg.latency_window_s:
            self.completions.popleft()
        while self.outcomes and self.outcomes[0][0] < t - cfg.error_window_s:
            self.outcomes.popleft()
        while self.arrivals and self.arrivals[0] < t - cfg.rps_window_s:
            self.arrivals.popleft()

    def snapshot(self) -> MetricsSnapshot:
        self._trim_windows()
        lat = [l for (_, l) in self.completions]
        p95 = float(np.percentile(lat, 95)) if lat else 0.0
        recent = [d for (td, d) in self.outcomes]
        err_rate = 1.0 - (sum(recent) / len(recent)) if recent else 0.0
        rps = len(self.arrivals) / self.cfg.rps_window_s  # offered load
        return MetricsSnapshot(
            t=self.t,
            p95_latency_s=p95,
            rps=rps,
            queue_depth=float(sum(len(t_.queue) for t_ in self.tiers)),
            error_rate=float(err_rate),
            tier_utilization=self.util_scrape.copy(),
            tier_queue_depth=np.asarray(
                [len(t_.queue) for t_ in self.tiers], dtype=np.float64),
            tier_up=np.asarray([t_.is_up(self.t) for t_ in self.tiers]),
        )

    # ------------------------------------------------------------------- run
    def run_window(self, weights: np.ndarray, window_s: float = 1.0):
        """Apply routing weights and advance the world one control window."""
        w = np.clip(np.asarray(weights, dtype=np.float64), 0.0, None)
        self.weights = w / max(w.sum(), 1e-12)
        end = self.t + window_s
        while self.events and self.events[0][0] <= end:
            time, _, kind, payload = heapq.heappop(self.events)
            self.t = time
            if kind == _ARRIVAL:
                self._on_arrival()
            else:
                self._on_completion(*payload)
            # pods coming back up drain their queue
            for i, tier in enumerate(self.tiers):
                if tier.is_up(self.t) and tier.queue and (
                        tier.busy < tier.cfg.servers):
                    self._dequeue(i)
        self.t = end
        # 10-second utilization scrape (paper §3)
        if self.t - self._last_scrape_t >= 10.0 - 1e-9:
            for i, tier in enumerate(self.tiers):
                tier.integrate(self.t)
                self.util_scrape[i] = tier.utilization(self._last_scrape_t,
                                                       self.t)
                tier.reset_util_window(self.t)
            self._last_scrape_t = self.t
        self._maybe_restart(window_s)


def run_experiment(router: Callable[[MetricsSnapshot], np.ndarray],
                   cfg: SimConfig,
                   duration_s: float,
                   seed: int = 0,
                   window_s: float = 1.0) -> RunResult:
    """Drive one (router, world) pair for ``duration_s`` simulated seconds.

    ``router`` is called once per control window with the current metrics
    snapshot and returns routing weights (one per tier, lightest first).
    """
    sim = EdgeSimulator(cfg, seed=seed)
    n_windows = int(round(duration_s / window_s))
    weights_trace = np.zeros((n_windows, len(cfg.tiers)))
    p95_trace = np.zeros(n_windows)
    error_trace = np.zeros(n_windows)
    for k in range(n_windows):
        snap = sim.snapshot()
        w = router(snap)
        weights_trace[k] = w
        p95_trace[k] = snap.p95_latency_s
        error_trace[k] = snap.error_rate
        sim.run_window(w, window_s)

    lat_ms = 1000.0 * np.asarray(sim.all_latencies) if sim.all_latencies else (
        np.asarray([0.0]))
    action_trace = (np.asarray(router.actions)
                    if hasattr(router, "actions") else None)
    return RunResult(
        action_trace=action_trace,
        n_requests=sim.n_requests,
        n_success=sim.n_success,
        n_error=sum(sim.errors.values()),
        error_breakdown=dict(sim.errors),
        p50_ms=float(np.percentile(lat_ms, 50)),
        p95_ms=float(np.percentile(lat_ms, 95)),
        tier_requests=sim.tier_requests.copy(),
        tier_success=sim.tier_success.copy(),
        n_restarts=np.asarray([t.n_restarts for t in sim.tiers]),
        weights_trace=weights_trace,
        p95_trace=p95_trace,
        error_trace=error_trace,
    )
