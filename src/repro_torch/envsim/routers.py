"""Router adapter connecting the AIF agent to metric snapshots (the port of
``repro/envsim/routers.py``).

``AifRouter`` wraps the single-agent Active Inference tick: every control
window it discretizes the metrics snapshot into the topology's observation
tuple, runs one :func:`repro_torch.core.agent.tick` (belief update → EFE
action selection → online learning on the slow cadence) and returns the
selected policy's routing weights as float64 numpy.  The tier count, state
space and policy set derive from the agent config's topology.

Its randomness comes from a ``noise=`` source with the ``repro_torch.noise``
protocol (the Gumbel noise of each tick, the replay indices of each slow
tick), by default a :class:`~repro_torch.noise.GeneratorNoise` seeded with
``seed``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import agent, fleet, generative, spaces
from repro_torch.device import resolve_device
from repro_torch.envsim.simulator import MetricsSnapshot
from repro_torch.noise import GeneratorNoise


class AifRouter:
    """The paper's router, driven by metric snapshots."""

    name = "aif"

    def __init__(self,
                 cfg: generative.AifConfig | None = None,
                 disc: spaces.DiscretizationConfig | None = None,
                 seed: int = 0,
                 adaptive_preferences: bool = True,
                 use_util_scrape: bool = True,
                 util_edges: tuple[float, ...] | None = None,
                 *, noise=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or generative.AifConfig()
        self.topo = self.cfg.topology
        self.disc = disc or spaces.DiscretizationConfig()
        self.state = fleet.init_fleet_state(self.cfg, 1, self.device)
        self.noise = noise if noise is not None else GeneratorNoise(
            seed, self.device)
        self.adaptive_preferences = adaptive_preferences
        self.use_util_scrape = use_util_scrape
        self.util_edges = np.asarray(
            self.topo.util_edges if util_edges is None else util_edges)
        self.ticks = 0
        self.actions: list[int] = []
        self.unstable_trace: list[bool] = []

    def __call__(self, snapshot: MetricsSnapshot) -> np.ndarray:
        raw = torch.tensor([[snapshot.p95_latency_s, snapshot.rps,
                             snapshot.queue_depth, snapshot.error_rate]],
                           dtype=torch.float32, device=self.device)
        obs_bins = spaces.discretize_observation(raw, self.disc)
        # Ablation lever: freeze the error EMA at 0 to disable adaptation.
        err = raw[:, 3] if self.adaptive_preferences else torch.zeros(
            1, device=self.device)
        # The paper's 10-second resource scrape: per-tier utilization,
        # reordered from tier order (lightest first) to state-factor order
        # (heaviest first).
        util_rev = snapshot.tier_utilization[::-1]
        util_bins = torch.tensor(
            np.sum(util_rev[:, None] >= self.util_edges[None, :], axis=-1),
            device=self.device)[None]
        util_valid = bool(self.use_util_scrape and self.ticks % 10 == 0
                          and self.ticks > 0)
        self.state, info = agent.tick(self.state, obs_bins, err, self.cfg,
                                      self.noise, self.ticks, util_bins,
                                      util_valid)
        self.ticks += 1
        self.actions.append(int(info.action[0]))
        self.unstable_trace.append(bool(info.unstable[0]))
        return info.routing_weights[0].cpu().numpy().astype(np.float64)
