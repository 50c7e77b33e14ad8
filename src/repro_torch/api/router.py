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

The AIF agent is :class:`repro_torch.api.aif.AifRouter`.  Of the
reference's baselines only :class:`UniformRouter` is ported; the capacity,
round-robin, least-loaded, min-response, Thompson and UCB routers are
ROADMAP item A5.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import policies

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
        return N_OBS_MODALITIES

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

    name = "uniform"

    @property
    def n_tiers(self) -> int:
        return self.tiers

    def step(self, carry, obs, obs_mask, noise):
        r, dev = obs.raw_obs.shape[0], obs.raw_obs.device
        w = torch.tensor(policies.balanced_weights(self.tiers),
                         dtype=torch.float32, device=dev)
        return carry, w.expand(r, self.tiers), _no_diag(r, dev)
