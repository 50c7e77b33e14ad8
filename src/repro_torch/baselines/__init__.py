"""Routing baselines of the event simulator: the paper's uniform baseline
+ stronger comparisons (the port of ``repro/baselines``: host numpy routers
over :class:`~repro_torch.envsim.simulator.MetricsSnapshot`)."""
from repro_torch.baselines.bandit import ThompsonRouter, UcbRouter
from repro_torch.baselines.least_loaded import LeastLoadedRouter
from repro_torch.baselines.static import (CapacityRouter, RoundRobinRouter,
                                    UniformRouter)

__all__ = ["ThompsonRouter", "UcbRouter", "LeastLoadedRouter",
           "CapacityRouter", "RoundRobinRouter", "UniformRouter"]
