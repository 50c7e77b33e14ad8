"""Declarative experiments: (topology, scenario, router, size, seed) -> run.

One :class:`Experiment` names everything a fleet experiment needs — the
topology preset, the scenario, the fleet size / horizon / seed, the router
and the device — and :func:`run` owns the assembly (sim config from the
topology, scenario schedules, fluid params, env adapter, router carry,
engine rollout, summary metrics)::

    from repro_torch import api
    res = api.run(api.Experiment(router="aif", scenario="paper-burst"))

Differences from the reference's ``repro.api.Experiment``: ``fused=True`` is
the default (``fused=False`` is ROADMAP A3), ``use_pallas`` is gone (the
device decides between kernel and plain version), and ``device`` defaults to
``"cuda"``.  ``mega=True`` runs the whole-window engine path.  The
registry holds ``aif`` and ``uniform``; the other baselines and
``compare``/``table1_grid`` are A5, sharding A10, checkpointing A8 and
graphs A9.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api import router as router_mod
from repro_torch.api.aif import AifRouter
from repro_torch.api.engine import rollout
from repro_torch.core import generative
from repro_torch.core.topology import Topology, default_topology, get_topology
from repro_torch.device import resolve_device
from repro_torch.envsim import batched, scenarios
from repro_torch.envsim.config import (SimConfig, discretization_for,
                                       sim_config_for)
from repro_torch.noise import Noise

_EPS = 1e-9


def _make_aif(topo: Topology, scfg: SimConfig, fused: bool, mega: bool,
              mega_slot_dtype: str = "float32") -> AifRouter:
    return AifRouter(cfg=generative.AifConfig(topology=topo),
                     disc=discretization_for(scfg), fused=fused, mega=mega,
                     mega_slot_dtype=mega_slot_dtype)


#: Router registry: name -> (topology, sim config, fused, mega,
#: mega_slot_dtype) -> Router.
ROUTERS: dict[str, Callable[..., router_mod.Router]] = {
    "aif": _make_aif,
    "uniform": lambda topo, scfg, *_: router_mod.UniformRouter(
        tiers=topo.n_tiers),
}

#: Reference routers that wait for ROADMAP item A5.
WAITING_ROUTERS = ("capacity", "round_robin", "least_loaded", "thompson",
                   "ucb", "nn_offload")


@dataclasses.dataclass(frozen=True)
class Experiment:
    """One declarative fleet experiment.

    Args:
      router: registry name (:data:`ROUTERS`) or a ready Router instance.
      scenario: scenario preset (:data:`repro_torch.envsim.scenarios.SCENARIOS`).
      topology: preset name or a :class:`~repro_torch.core.topology.Topology`.
      n_cells / n_windows: fleet size R and horizon T.
      seed: drives the scenario schedules and the rollout's noise.
      window_s: control-window length in seconds.
      fused / mega: AIF execution path (ignored for baselines): the fused
        per-tick path, or with ``mega=True`` the whole-window path (the run
        owns its carry: a fresh :class:`~repro_torch.core.mega.MegaFleetState`
        with one slot per control window, so ``n_windows`` must fit the
        replay capacity).  ``fused=False`` is ROADMAP A3.
      mega_slot_dtype: storage of the mega path's transition slots
        (``"float32"`` or ``"bfloat16"``).
      launch_periods: mega only, accepted for the reference's signature
        and otherwise ignored: the reference splits its one-launch rollout
        into launches of this many periods, and here every window is a
        launch of its own already.
      device: where the run's tensors live (``"cuda"`` by default; raises
        without a card unless ``"cpu"`` is asked for).
    """

    router: str | router_mod.Router = "aif"
    scenario: str = "paper-burst"
    topology: str | Topology = "paper-3tier"
    n_cells: int = 8
    n_windows: int = 300
    seed: int = 0
    window_s: float = 1.0
    fused: bool = True
    mega: bool = False
    mega_slot_dtype: str = "float32"
    launch_periods: int | None = None
    device: str = "cuda"

    def resolve_topology(self) -> Topology:
        return (get_topology(self.topology)
                if isinstance(self.topology, str) else self.topology)

    def resolve_router(self, scfg: SimConfig) -> router_mod.Router:
        if isinstance(self.router, router_mod.Router):
            return self.router
        if self.router in WAITING_ROUTERS:
            raise NotImplementedError(
                f"router {self.router!r} is not ported yet (ROADMAP item A5)")
        try:
            make = ROUTERS[self.router]
        except KeyError:
            raise KeyError(f"unknown router {self.router!r}; "
                           f"available: {sorted(ROUTERS)}") from None
        return make(self.resolve_topology(), scfg, self.fused, self.mega,
                    self.mega_slot_dtype)

    @property
    def name(self) -> str:
        return (self.router if isinstance(self.router, str)
                else self.router.name)


@dataclasses.dataclass
class RunResult:
    """Standardized outcome of one experiment (Table-1 row + raw artifacts).

    Scalar metrics aggregate over the R cells; the per-cell
    :class:`~repro_torch.envsim.batched.FluidResult`, the
    :class:`~repro_torch.core.fleet.FleetTrace` and the final router carry
    stay attached for drill-down.
    """

    experiment: Experiment
    name: str
    success_pct: float            # mean over cells, percent
    success_std: float            # std over cells, percent
    p50_ms: float
    p95_ms: float
    tier_share: np.ndarray        # (K,) share of successes, lightest first
    routed_share: np.ndarray      # (K,) share of routed requests
    restarts: float               # pod restarts summed over fleet
    obs_frac: float               # effective-observation fraction
    wall_s: float                 # rollout wall clock (synchronized)
    fluid: batched.FluidResult
    trace: Any
    final_carry: Any
    watchdog_events: float = 0.0  # quarantine-and-reinit events over the run


def _build_world(topo: Topology, scenario: str, n_cells: int, n_windows: int,
                 window_s: float, seed: int, device: torch.device):
    """(sim config, fluid params, env_step) for one experiment's world.

    The paper's testbed keeps its calibrated 50 RPS config; other
    topologies get the just-under-saturation config of their tier classes.
    """
    scfg = (SimConfig() if topo == default_topology()
            else sim_config_for(topo))
    sc = scenarios.build_scenario(scenario, scfg, n_cells, n_windows,
                                  window_s=window_s, seed=seed)
    params = batched.params_from_config(scfg, n_cells, sc.capacity_scale,
                                        device=device)
    env_step = batched.make_scenario_env_step(params, sc, dt=window_s)
    return scfg, params, env_step


def run(experiment: Experiment, noise: Noise | None = None) -> RunResult:
    """Assemble and execute one experiment on the batched engine.

    ``noise`` supplies every random draw of the rollout (see
    :mod:`repro_torch.noise`); None draws from a generator seeded with
    ``experiment.seed``.
    """
    e = experiment
    dev = resolve_device(e.device)
    topo = e.resolve_topology()
    scfg, params, env_step = _build_world(topo, e.scenario, e.n_cells,
                                          e.n_windows, e.window_s, e.seed,
                                          dev)
    router = e.resolve_router(scfg)
    if router.n_tiers != topo.n_tiers:
        raise ValueError(
            f"router {router.name!r} routes over {router.n_tiers} tiers but "
            f"topology {topo.tier_names} has {topo.n_tiers}")
    if e.launch_periods is not None:
        if not getattr(router, "mega", False):
            raise ValueError(
                "launch_periods only applies to mega routers (the per-tick "
                "engine has no launch granularity); set mega=True or drop it")
        if int(e.launch_periods) < 1:
            raise ValueError(
                f"launch_periods must be >= 1, got {e.launch_periods}")

    # a mega router owns its carry (fresh factored state sized to the run)
    carry = (None if getattr(router, "mega", False)
             else router.init_carry(e.n_cells, dev))
    est = batched.init_fluid_state(params, env_step.n_obs_modalities)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    carry, est, trace = rollout(router, carry, est, env_step, e.n_windows,
                                noise, seed=e.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    res = batched.summarize(est, trace.env)
    succ = 100.0 * res.success_rate
    n_success = np.maximum(res.n_success, _EPS)
    n_req = np.maximum(res.n_requests, _EPS)
    obs_frac = trace.obs_frac.cpu().numpy()
    # obs_frac[0] is the all-valid warm-up mask; report the steady part
    obs = float(obs_frac[1:].mean()) if obs_frac.shape[0] > 1 else 1.0
    wd = trace.watchdog
    return RunResult(
        experiment=e,
        name=e.name,
        success_pct=float(succ.mean()),
        success_std=float(succ.std()),
        p50_ms=float(res.p50_ms.mean()),
        p95_ms=float(res.p95_ms.mean()),
        tier_share=(res.tier_success / n_success[:, None]).mean(0),
        routed_share=(res.tier_requests / n_req[:, None]).mean(0),
        restarts=float(res.n_restarts.sum()),
        obs_frac=obs,
        wall_s=wall,
        fluid=res,
        trace=trace,
        final_carry=carry,
        watchdog_events=0.0 if wd is None else float(wd.sum()),
    )
