"""The AIF agent adapted onto the :class:`repro_torch.api.router.Router`
protocol.

The spec wraps the agent config, the observation discretization and the
utilization-scrape edges and cadence.  Three engine paths: the fused
per-tick path (``fused=True``, the port's default), the unfused per-tick
path (``fused=False``, the reference's default: the single-agent step
batched over R, plain PyTorch on the card as the reference runs it in XLA
with no Pallas kernel) and the whole-window path (``mega=True``, run by
:func:`repro_torch.api.engine.mega_rollout`).  The reference's
``use_pallas`` switch has no counterpart: the tensors' device decides
between a CUDA kernel and its plain PyTorch version.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.api.router import Router, RouterObs, TickInfo
from repro_torch.core import agent as agent_mod
from repro_torch.core import fleet as fleet_mod
from repro_torch.core import generative, spaces


@dataclasses.dataclass(frozen=True)
class AifRouter(Router):
    """Fleet spec of the Active Inference router (paper §4).

    Args:
      cfg: agent hyper-parameters; ``cfg.topology`` fixes every shape.
      disc: observation discretization (None = paper defaults).
      util_edges: raw-utilization level edges (None = the topology's).
      util_period: windows between utilization scrapes.
      fused: the fused belief→EFE fleet tick (kernel B1 on the card), or
        (False) the single-agent step batched over R in plain PyTorch.
      mega: run the whole-window engine path (factored fleet state, one
        fused launch per slow period); needs the dwell to divide the slow
        period and ``novelty_weight == 0``.
      mega_slot_dtype: storage of the mega path's transition slots,
        ``"float32"`` or ``"bfloat16"`` (float32 accumulation either way).
    """

    cfg: generative.AifConfig = dataclasses.field(
        default_factory=generative.AifConfig)
    disc: spaces.DiscretizationConfig | None = None
    util_edges: tuple[float, ...] | None = None
    util_period: int = 10
    fused: bool = True
    mega: bool = False
    mega_slot_dtype: str = "float32"

    name = "aif"

    def __post_init__(self):
        topo = self.cfg.topology
        disc = self.resolved_disc
        if len(disc.modality_edges()) != topo.n_modalities:
            raise ValueError(
                f"DiscretizationConfig covers {len(disc.modality_edges())} "
                f"modalities but the topology declares {topo.n_modalities} "
                f"({topo.modalities})")
        if len(self.resolved_util_edges) != topo.n_levels - 1:
            raise ValueError(
                f"util_edges needs {topo.n_levels - 1} edges for "
                f"{topo.n_levels}-level state factors, got "
                f"{self.resolved_util_edges}")
        if "error" not in topo.modalities:
            raise ValueError(
                f"topology modalities {topo.modalities} lack 'error': the "
                f"adaptive-preference EMA (paper §4.2) is driven by it")
        if self.mega:
            if self.period % self.dwell != 0:
                raise ValueError(
                    f"mega=True needs the dwell ({self.dwell} ticks) to "
                    f"divide the slow period ({self.period} ticks): every "
                    f"window starts on a selecting tick")
            if self.cfg.novelty_weight != 0.0:
                raise ValueError(
                    "mega=True does not implement the novelty bonus "
                    "(novelty_weight != 0); the fused kernels drop it")
        if self.mega_slot_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"mega_slot_dtype must be 'float32' or 'bfloat16', got "
                f"{self.mega_slot_dtype!r}")

    # ------------------------------------------------------- engine hints
    @property
    def slot_dtype(self) -> torch.dtype:
        """The torch dtype of the mega path's transition slots."""
        return (torch.bfloat16 if self.mega_slot_dtype == "bfloat16"
                else torch.float32)

    @property
    def n_tiers(self) -> int:
        return self.cfg.topology.n_tiers

    @property
    def n_modalities(self) -> int:
        return self.cfg.topology.n_modalities

    @property
    def period(self) -> int:
        return max(int(self.cfg.slow_period_s / self.cfg.fast_period_s), 1)

    @property
    def dwell(self) -> int:
        return max(int(self.cfg.action_dwell_s / self.cfg.fast_period_s), 1)

    @property
    def has_slow(self) -> bool:
        return True

    @property
    def resolved_disc(self) -> spaces.DiscretizationConfig:
        return self.disc or spaces.DiscretizationConfig()

    @property
    def resolved_util_edges(self) -> tuple[float, ...]:
        topo = self.cfg.topology
        return (topo.util_edges if self.util_edges is None
                else tuple(self.util_edges))

    def clock_phase(self, carry) -> int | None:
        vals = torch.unique(carry.t)
        # mixed clocks -> None: the engine falls back to per-tick slow gating
        return int(vals[0]) % self.period if vals.numel() == 1 else None

    # --------------------------------------------------------- transitions
    def init_carry(self, r: int, device: str | torch.device = "cuda"
                   ) -> agent_mod.AgentState:
        return fleet_mod.init_fleet_state(self.cfg, r, device)

    def _observe(self, obs: RouterObs):
        """Discretize the published telemetry and the 10 s utilization
        scrape (tier order -> state-factor order)."""
        topo = self.cfg.topology
        obs_bins = spaces.discretize_observation(obs.raw_obs,
                                                 self.resolved_disc)
        edges = torch.tensor(self.resolved_util_edges, dtype=torch.float32,
                             device=obs.raw_obs.device)
        util_hml = torch.flip(obs.tier_utilization, dims=(-1,))
        util_bins = torch.sum(util_hml[..., None] >= edges, dim=-1)
        util_valid = (obs.t_idx % self.util_period) == 0 and obs.t_idx > 0
        err_ix = topo.modalities.index("error")   # pinned by __post_init__
        return obs_bins, util_bins, util_valid, obs.raw_obs[:, err_ix]

    def _watchdog(self, carry):
        """Quarantine-and-reinit diverged cells on the incoming carry,
        before their state flows into this tick's belief/EFE math.  Returns
        (carry, (R,) float 0/1 events)."""
        bad = fleet_mod.fleet_watchdog_bad(carry)
        if bool(bad.any()):
            carry = fleet_mod.fleet_quarantine(carry, bad, self.cfg)
        return carry, bad.to(torch.float32)

    def step(self, carry, obs, obs_mask, noise):
        wd = None
        if self.cfg.watchdog:
            carry, wd = self._watchdog(carry)
        obs_bins, util_bins, util_valid, raw_err = self._observe(obs)
        r = obs_bins.shape[0]
        gumbel = noise.gumbel(obs.t_idx, (r, self.cfg.n_actions))
        carry, info = fleet_mod.fleet_fast_step(
            carry, obs_bins, raw_err, gumbel, self.cfg, util_bins,
            util_valid, obs_mask, fused=self.fused)
        return carry, info.routing_weights, TickInfo(action=info.action,
                                                     unstable=info.unstable,
                                                     watchdog=wd)

    def light_step(self, carry, obs, obs_mask):
        wd = None
        if self.cfg.watchdog:
            carry, wd = self._watchdog(carry)
        obs_bins, util_bins, util_valid, raw_err = self._observe(obs)
        carry, info = fleet_mod.fleet_light_step(
            carry, obs_bins, raw_err, self.cfg, util_bins, util_valid,
            obs_mask, fused=self.fused)
        return carry, info.routing_weights, TickInfo(action=info.action,
                                                     unstable=info.unstable,
                                                     watchdog=wd)

    def slow_step(self, carry, noise, t: int):
        idx = noise.replay_indices(t, carry.replay.size,
                                   self.cfg.replay_batch)
        return fleet_mod.fleet_slow_step(carry, idx, self.cfg)
