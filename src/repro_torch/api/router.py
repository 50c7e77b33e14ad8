"""The Router protocol: one contract for every routing policy.

* ``init_carry(r, device) -> carry`` — the router's state, batched over the
  R cells (deterministic; all randomness comes from the engine's noise),
* ``step(carry, obs, obs_mask, noise) -> (carry, weights, TickInfo)`` — one
  control tick for all R cells at once.  ``obs`` is a :class:`RouterObs`
  view of the previous window's telemetry, ``obs_mask`` the (R, M) validity
  mask (None = every modality fresh), ``noise`` the engine's
  :class:`repro_torch.noise.Noise` source and ``weights`` the (R, K)
  routing weights to apply this window,
* ``light_step`` (held ticks, routers with ``dwell > 1``) and
  ``slow_step(carry, noise, t)`` (once per slow period, ``has_slow``).

The AIF agent is :class:`repro_torch.api.aif.AifRouter`.  The baselines of
the paper's comparison (Table 1) live here, each the reference's router of
the same name (``repro/api/router.py``): :class:`UniformRouter`,
:class:`CapacityRouter`, :class:`RoundRobinRouter`,
:class:`LeastLoadedRouter`, the nearest-neighbor offloader
:class:`MinResponseRouter` and the :class:`ThompsonRouter` /
:class:`UcbRouter` bandits over the topology's policy table.  The bandits'
per-arm updates are a one-hot select over (R, A), so they need no scatter,
and Thompson's sampling noise is ``noise.normal(t, (R, A))``.  All of them
run plain PyTorch on the carry's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import policies
from repro_torch.core.topology import Topology, default_topology
from repro_torch.device import resolve_device

#: Telemetry modalities of the batched engine (p95_s, rps, queue, err).
N_OBS_MODALITIES = 4


class RouterObs(NamedTuple):
    """Per-tick observation view handed to :meth:`Router.step`."""

    raw_obs: torch.Tensor           # (R, M) published telemetry
    tier_utilization: torch.Tensor  # (R, K) last 10 s scrape, lightest first
    tier_up: torch.Tensor           # (R, K) liveness probe (1 = up)
    tier_queue: torch.Tensor        # (R, K) per-tier queue depth
    t_idx: int                      # window index


class TickInfo(NamedTuple):
    """Per-tick router diagnostics traced by the engine."""

    action: torch.Tensor            # (R,) policy index (0 if n/a)
    unstable: torch.Tensor          # (R,) bool adaptive-mode flag (AIF only)
    # (R,) float 0/1 — cells the numerical watchdog quarantined this tick
    # (None for routers without a watchdog)
    watchdog: Any = None


def _no_diag(r: int, device: torch.device) -> TickInfo:
    return TickInfo(action=torch.zeros((r,), dtype=torch.int64,
                                       device=device),
                    unstable=torch.zeros((r,), dtype=torch.bool,
                                         device=device))


class Router:
    """Base protocol; subclasses are frozen dataclasses.

    Engine hints: ``period`` / ``dwell`` are the slow-learning and
    action-dwell cadences in ticks, ``has_slow`` gates the once-per-period
    :meth:`slow_step`, ``n_tiers`` / ``n_modalities`` fix the observation
    buffer shapes.
    """

    name: str = "router"

    @property
    def n_tiers(self) -> int:
        raise NotImplementedError

    @property
    def n_modalities(self) -> int:
        # graph worlds publish extra telemetry columns; baselines that
        # ignore them size their buffers through ``extra_modalities``
        return N_OBS_MODALITIES + getattr(self, "extra_modalities", 0)

    @property
    def period(self) -> int:
        return 1

    @property
    def dwell(self) -> int:
        return 1

    @property
    def has_slow(self) -> bool:
        return False

    def clock_phase(self, carry) -> int | None:
        """Fast ticks already elapsed on the fleet clock, mod ``period``
        (None = mixed per-cell clocks)."""
        return 0

    def init_carry(self, r: int, device: str | torch.device = "cuda") -> Any:
        """Router state with leading cell axis R (deterministic)."""
        return ()

    def step(self, carry, obs: RouterObs, obs_mask, noise):
        """One control tick -> (carry, (R, K) weights, TickInfo)."""
        raise NotImplementedError

    def light_step(self, carry, obs: RouterObs, obs_mask):
        """Held tick (``dwell`` > 1 only)."""
        raise NotImplementedError(
            f"{type(self).__name__} declares dwell > 1 but no light_step")

    def slow_step(self, carry, noise, t: int):
        """Once-per-period learning (``has_slow`` only); ``t`` is the
        boundary tick whose draws it takes."""
        return carry


@dataclasses.dataclass(frozen=True)
class UniformRouter(Router):
    """Fixed near-uniform split — the paper's production baseline."""

    tiers: int = 3
    extra_modalities: int = 0

    name = "uniform"

    @property
    def n_tiers(self) -> int:
        return self.tiers

    def step(self, carry, obs, obs_mask, noise):
        r, dev = obs.raw_obs.shape[0], obs.raw_obs.device
        w = torch.tensor(policies.balanced_weights(self.tiers),
                         dtype=torch.float32, device=dev)
        return carry, w.expand(r, self.tiers), _no_diag(r, dev)


@dataclasses.dataclass(frozen=True)
class CapacityRouter(Router):
    """Weights proportional to known tier capacities — the prior knowledge
    AIF denies itself.  ``weights`` is normalized internally."""

    weights: tuple[float, ...] = (0.15, 0.23, 0.62)
    extra_modalities: int = 0

    name = "capacity"

    @property
    def n_tiers(self) -> int:
        return len(self.weights)

    def step(self, carry, obs, obs_mask, noise):
        r, dev = obs.raw_obs.shape[0], obs.raw_obs.device
        w = torch.tensor(self.weights, dtype=torch.float32, device=dev)
        w = w / torch.sum(w)
        return carry, w.expand(r, self.n_tiers), _no_diag(r, dev)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(idx, n).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class RoundRobinRouter(Router):
    """Cycles a one-hot weight across tiers every control window."""

    tiers: int = 3
    extra_modalities: int = 0

    name = "round_robin"

    @property
    def n_tiers(self) -> int:
        return self.tiers

    def init_carry(self, r: int, device: str | torch.device = "cuda"):
        return torch.zeros((r,), dtype=torch.int64,
                           device=resolve_device(device))

    def step(self, carry, obs, obs_mask, noise):
        tier = carry % self.tiers
        return carry + 1, _one_hot(tier, self.tiers), TickInfo(
            action=tier, unstable=torch.zeros_like(tier, dtype=torch.bool))


@dataclasses.dataclass(frozen=True)
class LeastLoadedRouter(Router):
    """Join-shortest-queue: traffic inversely proportional to per-tier queue
    depth, never to a down pod (the per-tier visibility the paper's router
    denies itself)."""

    softness: float = 1.0
    tiers: int = 3
    extra_modalities: int = 0

    name = "least_loaded"

    @property
    def n_tiers(self) -> int:
        return self.tiers

    def step(self, carry, obs, obs_mask, noise):
        r, dev = obs.raw_obs.shape[0], obs.raw_obs.device
        load = obs.tier_queue + 1.0
        w = (1.0 / load ** self.softness) * obs.tier_up
        total = torch.sum(w, dim=-1, keepdim=True)
        w = torch.where(total > 0, w / torch.clamp(total, min=1e-30),
                        torch.full_like(w, 1.0 / self.tiers))
        return carry, w, _no_diag(r, dev)


@dataclasses.dataclass(frozen=True)
class MinResponseRouter(Router):
    """Nearest-neighbor offloader: each window every cell sends all traffic
    to the up tier with the lowest estimated response time (queue drain +
    mean service); uniform when every tier is down.  ``service_s`` /
    ``cap_rps`` are the known per-tier mean service times and saturation
    throughputs (privileged knowledge, like :class:`CapacityRouter`'s)."""

    service_s: tuple[float, ...] = (0.18, 0.19, 0.23)
    cap_rps: tuple[float, ...] = (11.11, 15.79, 34.78)
    extra_modalities: int = 0

    name = "nn_offload"

    def __post_init__(self):
        if len(self.service_s) != len(self.cap_rps):
            raise ValueError(
                f"service_s covers {len(self.service_s)} tiers but cap_rps "
                f"{len(self.cap_rps)}; both come from the same tier list")

    @property
    def n_tiers(self) -> int:
        return len(self.service_s)

    def step(self, carry, obs, obs_mask, noise):
        dev = obs.raw_obs.device
        svc = torch.tensor(self.service_s, dtype=torch.float32, device=dev)
        cap = torch.tensor(self.cap_rps, dtype=torch.float32, device=dev)
        est = obs.tier_queue / torch.clamp(cap, min=1e-9) + svc    # (R, K)
        est = torch.where(obs.tier_up > 0, est, torch.inf)
        tier = torch.argmin(est, dim=-1)
        w = _one_hot(tier, self.n_tiers)
        all_down = torch.all(obs.tier_up <= 0, dim=-1, keepdim=True)
        w = torch.where(all_down, torch.full_like(w, 1.0 / self.n_tiers), w)
        return carry, w, TickInfo(
            action=tier, unstable=torch.zeros_like(tier, dtype=torch.bool))


# --------------------------------------------------------------- bandit family
def _bandit_reward(obs: RouterObs, latency_scale_s: float,
                   latency_weight: float) -> torch.Tensor:
    """(R,) per-window reward: success share minus normalized P95 (the
    hand-crafted reward AIF avoids).  Columns 0 and 3 are the batched
    engine's fixed emission order (p95_s, rps, queue, err), whatever order
    the AIF observation model gives its modalities.  The warm-up tick
    credits the engine's zero observation (reward 1.0) to arm 0."""
    err = obs.raw_obs[:, 3]
    p95 = obs.raw_obs[:, 0]
    return (1.0 - err) - latency_weight * torch.clamp(
        p95 / latency_scale_s, max=2.0)


def _arm_update(table: torch.Tensor, arm: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
    """``table`` (R, A) with row r's entry ``arm[r]`` set to ``value[r]``."""
    hit = torch.nn.functional.one_hot(arm, table.shape[1]).bool()
    return torch.where(hit, value[:, None], table)


def _arm_of(table: torch.Tensor, arm: torch.Tensor) -> torch.Tensor:
    return torch.gather(table, 1, arm[:, None])[:, 0]


class ThompsonCarry(NamedTuple):
    mu: torch.Tensor          # (R, A) posterior means
    var: torch.Tensor         # (R, A) posterior variances
    active_arm: torch.Tensor  # (R,) int64 arm credited with the next reward


@dataclasses.dataclass(frozen=True)
class ThompsonRouter(Router):
    """Gaussian Thompson sampling over the topology's generated policies
    (the same action space as AIF); the conjugate update of the reference,
    the sampling noise from ``noise.normal``."""

    topology: Topology = dataclasses.field(default_factory=default_topology)
    latency_scale_s: float = 5.0
    latency_weight: float = 0.5
    obs_noise: float = 0.25
    extra_modalities: int = 0

    name = "thompson"

    @property
    def n_tiers(self) -> int:
        return self.topology.n_tiers

    def init_carry(self, r: int, device: str | torch.device = "cuda"
                   ) -> ThompsonCarry:
        dev = resolve_device(device)
        a = policies.n_actions(self.topology)
        return ThompsonCarry(mu=torch.zeros((r, a), device=dev),
                             var=torch.ones((r, a), device=dev),
                             active_arm=torch.zeros((r,), dtype=torch.int64,
                                                    device=dev))

    def step(self, carry: ThompsonCarry, obs, obs_mask, noise):
        table = policies.policy_table(self.topology, carry.mu.device)
        reward = _bandit_reward(obs, self.latency_scale_s,
                                self.latency_weight)
        k = carry.active_arm
        var_k = _arm_of(carry.var, k)
        prec = 1.0 / var_k + 1.0 / self.obs_noise
        mu = _arm_update(carry.mu, k, (_arm_of(carry.mu, k) / var_k
                                       + reward / self.obs_noise) / prec)
        var = _arm_update(carry.var, k, 1.0 / prec)
        eps = noise.normal(obs.t_idx, tuple(mu.shape)).to(mu.device)
        arms = torch.argmax(mu + torch.sqrt(var) * eps, dim=-1)
        return ThompsonCarry(mu=mu, var=var, active_arm=arms), table[arms], \
            TickInfo(action=arms,
                     unstable=torch.zeros_like(arms, dtype=torch.bool))


class UcbCarry(NamedTuple):
    counts: torch.Tensor      # (R, A) pulls per arm
    sums: torch.Tensor        # (R, A) summed rewards per arm
    active_arm: torch.Tensor  # (R,) int64
    t: torch.Tensor           # (R,) int64 total pulls


@dataclasses.dataclass(frozen=True)
class UcbRouter(Router):
    """UCB1 over the topology's generated policies (deterministic)."""

    topology: Topology = dataclasses.field(default_factory=default_topology)
    c: float = 1.0
    latency_scale_s: float = 5.0
    latency_weight: float = 0.5
    extra_modalities: int = 0

    name = "ucb"

    @property
    def n_tiers(self) -> int:
        return self.topology.n_tiers

    def init_carry(self, r: int, device: str | torch.device = "cuda"
                   ) -> UcbCarry:
        dev = resolve_device(device)
        a = policies.n_actions(self.topology)
        return UcbCarry(counts=torch.zeros((r, a), device=dev),
                        sums=torch.zeros((r, a), device=dev),
                        active_arm=torch.zeros((r,), dtype=torch.int64,
                                               device=dev),
                        t=torch.zeros((r,), dtype=torch.int64, device=dev))

    def step(self, carry: UcbCarry, obs, obs_mask, noise):
        table = policies.policy_table(self.topology, carry.counts.device)
        reward = _bandit_reward(obs, self.latency_scale_s,
                                self.latency_weight)
        t = carry.t + 1
        k = carry.active_arm
        counts = _arm_update(carry.counts, k, _arm_of(carry.counts, k) + 1.0)
        sums = _arm_update(carry.sums, k, _arm_of(carry.sums, k) + reward)
        means = sums / torch.clamp(counts, min=1.0)
        bonus = self.c * torch.sqrt(
            torch.log(t.to(torch.float32) + 1.0)[:, None]
            / torch.clamp(counts, min=1e-9))
        bonus = torch.where(counts == 0, 1e9, bonus)
        arms = torch.argmax(means + bonus, dim=-1)
        return UcbCarry(counts=counts, sums=sums, active_arm=arms, t=t), \
            table[arms], TickInfo(
                action=arms,
                unstable=torch.zeros_like(arms, dtype=torch.bool))
