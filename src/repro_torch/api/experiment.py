"""Declarative experiments: (topology, scenario, router, size, seed) -> run.

One :class:`Experiment` names everything a fleet experiment needs — the
topology preset, the scenario, the fleet size / horizon / seed, the router
and the device — and :func:`run` owns the assembly (sim config from the
topology, scenario schedules, fluid params, env adapter, router carry,
engine rollout, summary metrics)::

    from repro_torch import api
    res = api.run(api.Experiment(router="aif", scenario="paper-burst"))

:func:`compare` runs a list of experiments and renders the paper's
Table-1 comparison as markdown or JSON; :func:`table1_grid` is its grid,
every router of :data:`TABLE1_ROUTERS` on clean and degraded telemetry::

    print(api.compare(api.table1_grid(n_cells=32, n_windows=300)).markdown())

Fault surface: ``checkpoint_every`` runs the horizon in boundary-aligned
chunks (:func:`repro_torch.api.engine.resumable_rollout`) and saves a
checkpoint (:mod:`repro_torch.checkpoint`) at each interior boundary;
``resume_from`` restores the newest readable one and finishes the run, to
the bit the uninterrupted run's final state.  Chaos scenarios
(:data:`repro_torch.envsim.chaos.CHAOS_INFO`) also get recovery metrics
against their uninjured control scenario (``RunResult.recovery``).

Differences from the reference's ``repro.api.Experiment``: ``fused=True`` is
the default, ``use_pallas`` is gone (the device decides between kernel and
plain version), and ``device`` defaults to ``"cuda"``.  ``mega=True`` runs
the whole-window engine path.  ``graph`` attaches a fleet graph
(:mod:`repro_torch.core.graph`): rejected load spills to graph neighbors
and the routers see a fifth, neighbor-pressure, telemetry column; the
graph scenario presets attach theirs by default.

Mega-fleets: ``shard="auto"`` (or a :class:`~repro_torch.api.shard.ShardSpec`)
runs the same experiment over row blocks of the cell axis, one a device
(:func:`repro_torch.api.engine.sharded_rollout`), with the per-tick trace
replaced by :class:`FleetMetricsReducer`'s O(R) stats::

    api.run(api.Experiment(router="least_loaded", n_cells=1_000_000,
                           n_windows=25, shard="auto"))

P50/P95 then come from fleet-global latency histograms, ``trace`` is None,
and the final env state still comes back per cell.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.api import engine as engine_mod
from repro_torch.api import router as router_mod
from repro_torch.api.aif import AifRouter
from repro_torch.api.engine import (resumable_rollout, rollout,
                                    sharded_finalize,
                                    sharded_resumable_rollout,
                                    sharded_rollout)
from repro_torch.api.shard import ShardSpec, resolve as resolve_shard
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import generative
from repro_torch.core import graph as graph_mod
from repro_torch.core import mega as mega_mod
from repro_torch.core.topology import Topology, default_topology, get_topology
from repro_torch.device import resolve_device
from repro_torch.envsim import batched, scenarios
from repro_torch.envsim import chaos as chaos_mod
from repro_torch.envsim.config import (SimConfig, discretization_for,
                                       sim_config_for)
from repro_torch.noise import GeneratorNoise, Noise, get_state, set_state

_EPS = 1e-9


def _make_aif(topo: Topology, scfg: SimConfig, fused: bool, mega: bool,
              mega_slot_dtype: str = "float32",
              graph: graph_mod.FleetGraph | None = None) -> AifRouter:
    disc = discretization_for(scfg)
    if graph is not None:
        # graphed worlds publish a fifth telemetry column (neighbor
        # pressure): grow the topology's modalities and the bin edges
        topo = graph_mod.with_neighbor_modality(topo)
        disc = dataclasses.replace(
            disc, edges=disc.modality_edges() + (graph_mod.NEIGHBOR_EDGES,))
    return AifRouter(cfg=generative.AifConfig(topology=topo), disc=disc,
                     fused=fused, mega=mega, mega_slot_dtype=mega_slot_dtype)


def _capacity_weights(scfg: SimConfig) -> tuple[float, ...]:
    """Weights proportional to CPU limits, rounded to two decimals with the
    remainder on the heaviest tier: the paper's (0.15, 0.23, 0.62) for the
    2:3:8 testbed."""
    total = sum(t.servers for t in scfg.tiers)
    w = [round(t.servers / total, 2) for t in scfg.tiers[:-1]]
    return tuple(w) + (round(1.0 - sum(w), 2),)


#: Router registry: name -> (topology, sim config, fused, mega,
#: mega_slot_dtype) -> Router.  The baselines ignore the AIF execution
#: options; ``capacity`` and ``nn_offload`` read the sim config's tiers (the
#: prior knowledge AIF learns online).
ROUTERS: dict[str, Callable[..., router_mod.Router]] = {
    "aif": _make_aif,
    "uniform": lambda topo, scfg, *_: router_mod.UniformRouter(
        tiers=topo.n_tiers),
    "capacity": lambda topo, scfg, *_: router_mod.CapacityRouter(
        weights=_capacity_weights(scfg)),
    "round_robin": lambda topo, scfg, *_: router_mod.RoundRobinRouter(
        tiers=topo.n_tiers),
    "least_loaded": lambda topo, scfg, *_: router_mod.LeastLoadedRouter(
        tiers=topo.n_tiers),
    "thompson": lambda topo, scfg, *_: router_mod.ThompsonRouter(
        topology=topo),
    "ucb": lambda topo, scfg, *_: router_mod.UcbRouter(topology=topo),
    # nearest-neighbor offloader: greedy min estimated response time
    # (queue / capacity + service) over the live tiers
    "nn_offload": lambda topo, scfg, *_: router_mod.MinResponseRouter(
        service_s=tuple(t.mean_service_s for t in scfg.tiers),
        cap_rps=tuple(t.servers / t.mean_service_s for t in scfg.tiers)),
}

#: The paper's Table-1 lineup: AIF, the five baseline families (Thompson
#: and UCB are the bandit family) and the nearest-neighbor offloader.
TABLE1_ROUTERS = ("aif", "uniform", "capacity", "round_robin",
                  "least_loaded", "thompson", "ucb", "nn_offload")


def _graphify_router(r: router_mod.Router,
                     graph: graph_mod.FleetGraph | None) -> router_mod.Router:
    """Grow a router to the graphed engine's 5-column observation.

    Baselines carry an ``extra_modalities`` field: the neighbor-pressure
    column rides their observation buffers unread.  A router without the
    field (an :class:`AifRouter` instance) must already consume the
    neighbor modality; a mismatch raises here.
    """
    if graph is None:
        return r
    if getattr(r, "extra_modalities", None) == 0:
        r = dataclasses.replace(r, extra_modalities=1)
    expect = batched.N_OBS_MODALITIES + 1
    if r.n_modalities != expect:
        raise ValueError(
            f"graphed worlds emit {expect} observation modalities (neighbor "
            f"pressure appended) but router {r.name!r} consumes "
            f"{r.n_modalities}; build AIF via router='aif' or with "
            f"repro_torch.core.graph.with_neighbor_modality(topology)")
    return r


# ---------------------------------------------------------- sharded reduction
#: Fleet-global latency histogram: 512 log-spaced bins over 0.1 ms .. 1000 s
#: (~3.2 % wide, ±1.6 % on a reported quantile).
_HIST_BINS = 512
_HIST_LO_S = 1e-4
_HIST_HI_S = 1e3
_HIST_SCALE = _HIST_BINS / (np.log(_HIST_HI_S) - np.log(_HIST_LO_S))
#: The histograms hold completion mass as integers of 2**-20 request: an
#: integer sum is exact, so the bins are the same bits whatever order the
#: device adds them in (float atomics are not), on a rerun and on resume.
_HIST_ONE = 2.0 ** 20


def _hist_quantile(hist: np.ndarray, q: float) -> float:
    """Mass-weighted quantile (seconds) of a log-spaced latency histogram:
    the geometric midpoint of the first bin whose cumulative mass reaches
    ``q``, the completion-weighted convention of
    :func:`repro_torch.envsim.batched.summarize` quantized to a bin."""
    hist = np.asarray(hist, np.float64)
    total = hist.sum()
    if total <= 0:
        return 0.0
    idx = int(np.searchsorted(np.cumsum(hist) / total, q).clip(
        0, _HIST_BINS - 1))
    return float(np.exp(np.log(_HIST_LO_S) + (idx + 0.5) / _HIST_SCALE))


@dataclasses.dataclass(frozen=True)
class FleetMetricsReducer:
    """O(R)-memory metrics accumulator of the sharded engine.

    Replaces the stacked (T, R, ...) trace with a few small tensors per
    shard (the contract :func:`repro_torch.api.engine.sharded_rollout`
    expects).  A shard's stats are ``(valid, hist50, hist95, obs_sum,
    spill_sum)``: ``valid`` masks the shard's phantom pad rows (cells at or
    past the true R add nothing), the histograms hold completion mass over
    the mean and P95 tier-latency atoms (int64, in units of ``2**-20``
    request: :data:`_HIST_ONE`), ``obs_sum`` totals the per-cell
    effective-observation fraction over the steady ticks (t >= 1) and
    ``spill_sum`` the spillover mass admitted at graph neighbors (zero on
    ungraphed worlds).
    """

    n_cells: int

    def init(self, r_local: int, row0: int,
             device: str | torch.device = "cpu") -> tuple:
        rows = row0 + torch.arange(r_local, device=device)
        hist = torch.zeros((_HIST_BINS,), dtype=torch.int64, device=device)
        zero = torch.zeros((), device=device)
        return ((rows < self.n_cells).to(torch.float32), hist, hist.clone(),
                zero, zero.clone())

    @staticmethod
    def _deposit(hist, lat, mass):
        # log-spaced bin; lat == 0 maps to -inf, clipped into bin 0 where
        # its zero mass is harmless
        idx = torch.clamp(torch.floor(
            (torch.log(torch.clamp(lat, min=0.0)) - np.log(_HIST_LO_S))
            * _HIST_SCALE), 0, _HIST_BINS - 1).long()
        units = torch.round(mass.double() * _HIST_ONE).long()
        return hist.index_add(0, idx.reshape(-1), units.reshape(-1))

    def update(self, stats, t_idx: int, ys):
        """Fold one tick's trace (``ys.env`` a WindowInfo, ``ys.obs_frac``
        (R,)) into a shard's stats."""
        valid, hist50, hist95, obs_sum, spill_sum = stats
        mass = ys.env.tier_completed * valid[:, None]
        hist50 = self._deposit(hist50, ys.env.tier_latency_s, mass)
        hist95 = self._deposit(hist95, ys.env.tier_p95_s, mass)
        # obs_frac at tick 0 is the all-valid warm-up mask: steady ticks only
        if t_idx >= 1:
            obs_sum = obs_sum + torch.sum(ys.obs_frac * valid)
        spill = getattr(ys.env, "spill_admitted", None)
        if spill is not None:
            spill_sum = spill_sum + torch.sum(spill * valid)
        return (valid, hist50, hist95, obs_sum, spill_sum)

    def update_window(self, stats, t0: int, ys):
        """Fold one mega window's stacked (W, ...) trace in at once; the
        histograms equal W :meth:`update` calls to the bit, the sums to
        rounding."""
        valid, hist50, hist95, obs_sum, spill_sum = stats
        mass = ys.env.tier_completed * valid[None, :, None]
        hist50 = self._deposit(hist50, ys.env.tier_latency_s, mass)
        hist95 = self._deposit(hist95, ys.env.tier_p95_s, mass)
        w = ys.obs_frac.shape[0]
        steady = (t0 + torch.arange(w, device=valid.device) >= 1).to(
            torch.float32)
        obs_sum = obs_sum + torch.sum(steady[:, None] * ys.obs_frac
                                      * valid[None, :])
        spill = getattr(ys.env, "spill_admitted", None)
        if spill is not None:
            spill_sum = spill_sum + torch.sum(spill * valid[None, :])
        return (valid, hist50, hist95, obs_sum, spill_sum)

    def finalize(self, stats) -> tuple:
        """The fleet's (hist50, hist95, obs_sum, spill_sum) from the shards'
        stats stacked on a leading shard axis, summed in shard order; the
        histograms as float64 request mass."""
        _, hist50, hist95, obs_sum, spill_sum = stats
        out = []
        for x in (hist50, hist95, obs_sum, spill_sum):
            total = x[0]
            for d in range(1, x.shape[0]):
                total = total + x[d]
            out.append(total)
        return (out[0].double() / _HIST_ONE, out[1].double() / _HIST_ONE,
                out[2], out[3])


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
        per-tick path (``fused=False``: the single-agent step batched over
        R, plain PyTorch), or with ``mega=True`` the whole-window path (the
        run owns its carry: a fresh
        :class:`~repro_torch.core.mega.MegaFleetState` with one slot per
        control window, so ``n_windows`` must fit the replay capacity).
      mega_slot_dtype: storage of the mega path's transition slots
        (``"float32"`` or ``"bfloat16"``).
      launch_periods: mega only, accepted for the reference's signature
        and otherwise ignored: the reference splits its one-launch rollout
        into launches of this many periods, and here every window is a
        launch of its own already.
      device: where the run's tensors live (``"cuda"`` by default; raises
        without a card unless ``"cpu"`` is asked for).
      shard: sharding of the cell axis over local devices of ``device``'s
        type: None (unsharded, with the full per-tick trace), ``"auto"``
        (every local device) or a :class:`~repro_torch.api.shard.ShardSpec`.
        A sharded run keeps O(R) memory by reducing the metrics as it goes
        (``RunResult.trace`` is None, P50/P95 are fleet-global histogram
        quantiles), pads R to a device multiple with inert phantom cells
        (unless the spec says ``pad="strict"``), and its results do not
        depend on the device count.  Composes with ``mega``, graphs, chaos
        and checkpoints (a resume needs the shard count it was written
        under).
      checkpoint_every: windows between checkpoints (0 = off), a multiple
        of the router's slow period and dwell: the run goes in chunks of
        this many windows and saves (router carry, env state, telemetry
        carry, noise position) at every interior boundary.
      checkpoint_dir: where the checkpoints go (needed with
        ``checkpoint_every``; defaults to ``resume_from``).
      resume_from: checkpoint directory of an interrupted run of this same
        experiment: the run restores the newest readable checkpoint (a
        corrupt one is skipped with a warning) onto ``device`` and goes on
        to ``n_windows``.  The final states equal the uninterrupted run's
        to the bit; the trace covers the resumed windows only (the env's
        cumulative counters cover the whole horizon).
      graph: fleet graph — None (ungraphed, except that the graph scenario
        presets attach their :data:`repro_torch.core.graph.GRAPH_SCENARIOS`
        preset), a preset name (``"ring"`` / ``"grid"`` / ``"hier"`` /
        ``"none"``, the last forcing the ungraphed program on any
        scenario) or a :class:`~repro_torch.core.graph.FleetGraph`.  A
        graphed world spills rejected load to graph neighbors and publishes
        a fifth, neighbor-pressure, telemetry modality; registry routers
        grow to consume it.
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
    shard: ShardSpec | str | None = None
    checkpoint_every: int = 0
    checkpoint_dir: str | None = None
    resume_from: str | None = None
    graph: graph_mod.FleetGraph | str | None = None

    def resolve_topology(self) -> Topology:
        return (get_topology(self.topology)
                if isinstance(self.topology, str) else self.topology)

    def resolve_graph(self) -> graph_mod.FleetGraph | None:
        """The effective fleet graph (None = the exact ungraphed program):
        an explicit graph or preset name wins, else the graph scenario
        presets attach theirs; ``graph="none"`` always resolves to None."""
        return graph_mod.resolve_graph(self.graph, self.n_cells,
                                       scenario=self.scenario)

    def resolve_router(self, scfg: SimConfig,
                       graph: graph_mod.FleetGraph | None = None
                       ) -> router_mod.Router:
        if isinstance(self.router, router_mod.Router):
            return _graphify_router(self.router, graph)
        try:
            make = ROUTERS[self.router]
        except KeyError:
            raise KeyError(f"unknown router {self.router!r}; "
                           f"available: {sorted(ROUTERS)}") from None
        if self.router == "aif":
            return _make_aif(self.resolve_topology(), scfg, self.fused,
                             self.mega, self.mega_slot_dtype, graph=graph)
        return _graphify_router(
            make(self.resolve_topology(), scfg, self.fused, self.mega,
                 self.mega_slot_dtype), graph)

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
    stay attached for drill-down.  ``success_pct`` is the mean of per-cell
    success rates on ungraphed worlds and the fleet-global ratio
    ΣnSuccess/ΣnRequests on graphed ones (spillover credits a completion
    to the receiving cell, so per-cell ratios mean little there).
    """

    experiment: Experiment
    name: str
    success_pct: float            # percent (see the class docstring)
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
    # chunk boundaries (windows): interior checkpoint saves, plus the
    # restored start window on a resumed run
    resume_points: tuple = ()
    # chaos recovery metrics (None: the scenario has no registered control)
    recovery: dict | None = None
    # share of the offered load absorbed at a graph neighbor after
    # spillover (0.0 on ungraphed worlds)
    offload_frac: float = 0.0
    # cells a shard holds, padding included (R when unsharded)
    cells_per_device: int = 0

    def summary(self) -> dict:
        """JSON-safe metric dict (one Table-1 row)."""
        e = self.experiment
        return {
            "router": self.name,
            "scenario": e.scenario,
            "n_cells": e.n_cells,
            "n_windows": e.n_windows,
            "device": e.device,
            "success_pct": round(self.success_pct, 2),
            "success_std": round(self.success_std, 2),
            "p50_ms": round(self.p50_ms, 1),
            "p95_ms": round(self.p95_ms, 1),
            "tier_share_of_success": [round(float(x), 4)
                                      for x in self.tier_share],
            "routed_share": [round(float(x), 4) for x in self.routed_share],
            "restarts": round(self.restarts, 1),
            "obs_frac": round(self.obs_frac, 4),
            "offload_frac": round(self.offload_frac, 4),
            "wall_s": round(self.wall_s, 2),
            "cells_per_device": self.cells_per_device,
            "watchdog_events": round(self.watchdog_events, 1),
            **({"recovery": {k: (round(v, 4) if isinstance(v, float) else v)
                             for k, v in self.recovery.items()}}
               if self.recovery is not None else {}),
        }


def _build_world(topo: Topology, scenario: str, n_cells: int, n_windows: int,
                 window_s: float, seed: int, device: torch.device,
                 graph: graph_mod.FleetGraph | None = None):
    """(sim config, fluid params, env_step) for one experiment's world.

    The paper's testbed keeps its calibrated 50 RPS config; other
    topologies get the just-under-saturation config of their tier classes.
    A graph is built at the true fleet size: no edge reaches past
    ``n_cells``.
    """
    if graph is not None:
        graph.validate_true_rows(n_cells)
    scfg = (SimConfig() if topo == default_topology()
            else sim_config_for(topo))
    sc = scenarios.build_scenario(scenario, scfg, n_cells, n_windows,
                                  window_s=window_s, seed=seed)
    params = batched.params_from_config(scfg, n_cells, sc.capacity_scale,
                                        device=device)
    env_step = batched.make_scenario_env_step(params, sc, dt=window_s,
                                              graph=graph)
    return scfg, params, env_step


@functools.lru_cache(maxsize=2)
def _build_world_padded(topo: Topology, scenario: str, n_cells: int,
                        n_windows: int, window_s: float, seed: int,
                        r_pad: int, n_devices: int, device: torch.device,
                        graph: graph_mod.FleetGraph | None = None):
    """:func:`_build_world` for a sharded run: the world built at the true
    R, then padded to ``r_pad`` with inert phantom cells
    (:func:`repro_torch.envsim.scenarios.pad_scenario`; the per-cell draws
    of a scenario depend on R, so building at ``r_pad`` would change the
    real cells' schedules with the device count).  The params, the env
    adapter and the graph's edge lists live at ``r_pad``.  Memoized on
    every argument, the padded size and the shard count included: two
    shardings of one R never share an ``env_step``.
    """
    if graph is not None:
        graph.validate_true_rows(n_cells)
    scfg = (SimConfig() if topo == default_topology()
            else sim_config_for(topo))
    sc = scenarios.build_scenario(scenario, scfg, n_cells, n_windows,
                                  window_s=window_s, seed=seed)
    sc = scenarios.pad_scenario(sc, r_pad)
    params = batched.params_from_config(scfg, r_pad, sc.capacity_scale,
                                        device=device)
    env_step = batched.make_scenario_env_step(params, sc, dt=window_s,
                                              graph=graph)
    return scfg, params, env_step


def run(experiment: Experiment, noise: Noise | None = None) -> RunResult:
    """Assemble and execute one experiment on the batched engine.

    ``noise`` supplies every random draw of the rollout (see
    :mod:`repro_torch.noise`); None draws from a generator seeded with
    ``experiment.seed``.  A chaos scenario is run again on its control
    scenario, with the draws it started from, for ``RunResult.recovery``
    (not on a sharded run, whose trace is reduced away).
    """
    e = experiment
    dev = resolve_device(e.device)
    start = get_state(noise)
    spec = resolve_shard(e.shard)
    res = (_run_dense(e, dev, noise) if spec is None
           else _run_sharded(e, dev, spec, noise))
    info = chaos_mod.CHAOS_INFO.get(e.scenario)
    if info is not None and res.trace is not None:
        set_state(noise, start)
        control = run(dataclasses.replace(
            e, scenario=info.base, checkpoint_every=0, checkpoint_dir=None,
            resume_from=None), noise)
        res.recovery = _recovery_metrics(e, info, res, control)
    return res


def _run_dense(e: Experiment, dev: torch.device,
               noise: Noise | None) -> RunResult:
    """One run on the per-tick or the mega engine, in one piece or in
    checkpointed chunks."""
    topo = e.resolve_topology()
    graph = e.resolve_graph()
    scfg, params, env_step = _build_world(topo, e.scenario, e.n_cells,
                                          e.n_windows, e.window_s, e.seed,
                                          dev, graph)
    router = e.resolve_router(scfg, graph)
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

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    if e.checkpoint_every or e.resume_from:
        carry, est, trace, boundaries = _chunked_rollout(e, router, params,
                                                         env_step, noise,
                                                         dev)
    else:
        # a mega router owns its carry (fresh factored state sized to the run)
        carry = (None if getattr(router, "mega", False)
                 else router.init_carry(e.n_cells, dev))
        est = batched.init_fluid_state(params, env_step.n_obs_modalities)
        carry, est, trace = rollout(router, carry, est, env_step,
                                    e.n_windows, noise, seed=e.seed)
        boundaries = ()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    res = batched.summarize(est, trace.env)
    succ = 100.0 * res.success_rate
    total_req = max(float(res.n_requests.sum()), 1.0)
    # spillover credits a completion to the receiving cell while the
    # request counts at its origin, so per-cell ratios can pass 1 on a
    # graph: report the fleet-global ratio there
    succ_mean = (100.0 * float(res.n_success.sum()) / total_req
                 if env_step.has_graph else float(succ.mean()))
    n_success = np.maximum(res.n_success, _EPS)
    n_req = np.maximum(res.n_requests, _EPS)
    obs_frac = trace.obs_frac.cpu().numpy()
    # obs_frac[0] is the all-valid warm-up mask; report the steady part
    obs = float(obs_frac[1:].mean()) if obs_frac.shape[0] > 1 else 1.0
    spill = trace.env.spill_admitted
    offload = (0.0 if spill is None else
               float(spill.cpu().numpy().astype(np.float64).sum())
               / total_req)
    wd = trace.watchdog
    return RunResult(
        experiment=e,
        name=e.name,
        success_pct=succ_mean,
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
        resume_points=tuple(boundaries),
        offload_frac=offload,
        cells_per_device=e.n_cells,
    )


def _run_sharded(e: Experiment, dev: torch.device, spec: ShardSpec,
                 noise: Noise | None, mesh: list | None = None) -> RunResult:
    """One run on the sharded engine, in one piece or in checkpointed
    chunks.

    The same world, router and draws as the unsharded run, over row blocks
    (``mesh``: the shards' devices, default ``spec.build_mesh(dev)``) with
    the metrics reduced on the way (:class:`FleetMetricsReducer`):
    ``trace`` is None and P50/P95 are fleet-global completion-weighted
    histogram quantiles, not the unsharded run's mean of per-cell ones.
    Success, tier shares, restarts and offload come from the final env
    state's true rows, as in the unsharded run.
    """
    if e.launch_periods is not None:
        raise ValueError(
            "launch_periods is not available on sharded runs; drop shard or "
            "launch_periods")
    topo = e.resolve_topology()
    graph = e.resolve_graph()
    mesh = spec.build_mesh(dev) if mesh is None else list(mesh)
    r_pad, r_local = spec.padded(e.n_cells, len(mesh))
    scfg, params, env_step = _build_world_padded(
        topo, e.scenario, e.n_cells, e.n_windows, e.window_s, e.seed, r_pad,
        len(mesh), dev, graph)
    router = e.resolve_router(scfg, graph)
    if router.n_tiers != topo.n_tiers:
        raise ValueError(
            f"router {router.name!r} routes over {router.n_tiers} tiers but "
            f"topology {topo.tier_names} has {topo.n_tiers}")
    reducer = FleetMetricsReducer(n_cells=e.n_cells)

    _sync(mesh)
    t0 = time.perf_counter()
    boundaries: tuple = ()
    if e.checkpoint_every or e.resume_from:
        carry, est, stats, boundaries = _sharded_chunked(
            e, router, params, env_step, spec, reducer, noise, dev, mesh)
    else:
        carry, est, stats = sharded_rollout(
            router, batched.init_fluid_state(params,
                                             env_step.n_obs_modalities),
            env_step, e.n_windows, noise, shard=spec, n_cells=e.n_cells,
            reducer=reducer, seed=e.seed, mesh=mesh)
    _sync(mesh)
    wall = time.perf_counter() - t0

    hist50, hist95, obs_sum, spill_sum = (x.cpu().numpy() for x in stats)
    p50_s = _hist_quantile(hist50, 0.50)
    p95_s = _hist_quantile(hist95, 0.95)
    # the true rows of the final state, with the fleet-global quantiles in
    # the per-cell columns (per-cell ones would need the trace)
    final = type(est)(*(x[:e.n_cells].cpu().numpy() for x in est))
    res = batched.FluidResult(
        n_requests=final.n_requests,
        n_success=final.n_success,
        success_rate=final.n_success / np.maximum(final.n_requests, _EPS),
        error_breakdown={"timeout": final.err_timeout,
                         "overflow": final.err_overflow,
                         "refused": final.err_refused,
                         "restart": final.err_restart},
        p95_ms=np.full(e.n_cells, 1000.0 * p95_s),
        p50_ms=np.full(e.n_cells, 1000.0 * p50_s),
        tier_requests=final.tier_requests,
        tier_success=final.tier_success,
        n_restarts=final.n_restarts)
    succ = 100.0 * res.success_rate
    total_req = max(float(final.n_requests.sum()), 1.0)
    succ_mean = (100.0 * float(final.n_success.sum()) / total_req
                 if env_step.has_graph else float(succ.mean()))
    n_success = np.maximum(res.n_success, _EPS)
    n_req = np.maximum(res.n_requests, _EPS)
    steady = max(e.n_windows - 1, 1) * e.n_cells
    return RunResult(
        experiment=e,
        name=e.name,
        success_pct=succ_mean,
        success_std=float(succ.std()),
        p50_ms=1000.0 * p50_s,
        p95_ms=1000.0 * p95_s,
        tier_share=(res.tier_success / n_success[:, None]).mean(0),
        routed_share=(res.tier_requests / n_req[:, None]).mean(0),
        restarts=float(res.n_restarts.sum()),
        obs_frac=float(obs_sum) / steady if e.n_windows > 1 else 1.0,
        wall_s=wall,
        fluid=res,
        trace=None,
        final_carry=carry,
        resume_points=tuple(boundaries),
        offload_frac=float(spill_sum) / total_req,
        cells_per_device=r_local,
    )


def _sync(mesh: list) -> None:
    """Wait for every CUDA device of ``mesh``."""
    for d in dict.fromkeys(mesh):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


# ------------------------------------------- checkpointing + recovery metrics
def _ckpt_template(e: Experiment, router, params, noise,
                   n_modalities: int, r: int | None = None) -> dict:
    """Shapes and dtypes of a checkpoint's tree, for restore, at ``r``
    cells (default the experiment's; a sharded run's padded fleet).  The
    carries are built on the ``meta`` device, so a resume allocates them
    once (restore loads each leaf onto the experiment's device)."""
    r = e.n_cells if r is None else r
    meta = torch.device("meta")
    if getattr(router, "mega", False):
        carry = mega_mod.init_mega_state(router.cfg, r, e.n_windows,
                                         router.slot_dtype, meta)
    else:
        carry = router.init_carry(r, meta)
    env = batched.init_fluid_state(params, n_modalities)
    tmpl = {"carry": carry,
            "env": type(env)(*(torch.empty_like(x, device=meta)
                               for x in env)),
            "obs": engine_mod._fresh_obs_carry(r, router.n_modalities,
                                               router.n_tiers, meta)}
    state = get_state(noise)
    if state is not None:
        tmpl["noise"] = state
    return tmpl


def _restore(e: Experiment, tmpl: dict, dev: torch.device):
    """The newest readable checkpoint of ``e.resume_from`` shaped like
    ``tmpl`` on ``dev``: (tree, extra), checked against the experiment."""
    tree, extra = Checkpointer(e.resume_from).restore(tmpl, device=dev)
    t_begin = int(extra["t"])
    if extra.get("scenario") not in (None, e.scenario):
        raise ValueError(
            f"resume_from checkpoint was written for scenario "
            f"{extra['scenario']!r}, not {e.scenario!r}: resuming would "
            f"splice two different worlds")
    if t_begin >= e.n_windows:
        raise ValueError(f"checkpoint is at window {t_begin} but the "
                         f"experiment ends at {e.n_windows}")
    return tree, extra


def _ckpt_payload(carry, env, snapshot, sharded: bool) -> dict:
    """A checkpoint's tree at a chunk boundary: the router carry, the env
    state, the snapshot's telemetry carry and noise position and, for a
    sharded run, the reducer's raw stats (a leading shard axis)."""
    if sharded:
        obs, stats, noise_state = snapshot
    else:
        (obs, noise_state), stats = snapshot, None
    tree = {"carry": carry, "env": env, "obs": tuple(obs)}
    if stats is not None:
        tree["stats"] = stats
    if noise_state is not None:
        tree["noise"] = noise_state
    return tree


def _chunk_sizes(e: Experiment, t_begin: int):
    t = t_begin
    while t < e.n_windows:
        n = (min(e.checkpoint_every, e.n_windows - t) if e.checkpoint_every
             else e.n_windows - t)
        yield t, n
        t += n


def _cat(xs):
    """Concatenate per-chunk traces along time, field by field."""
    if xs[0] is None:
        return None
    if isinstance(xs[0], torch.Tensor):
        return torch.cat(xs)
    return type(xs[0])(*(_cat(f) for f in zip(*xs)))


def _chunked_rollout(e: Experiment, router, params, env_step,
                     noise: Noise | None, dev: torch.device):
    """The run as :func:`~repro_torch.api.engine.resumable_rollout` chunks
    between boundary-aligned windows, saving (router carry, env state,
    snapshot) at every interior boundary; from ``resume_from``'s newest
    readable checkpoint when it is set.

    Returns (carry, env state, trace of the chunks run, boundaries).
    """
    if e.checkpoint_every:
        engine_mod._check_boundary(router, int(e.checkpoint_every))
    ck_dir = e.checkpoint_dir or e.resume_from
    if e.checkpoint_every and not ck_dir:
        raise ValueError("checkpoint_every > 0 needs checkpoint_dir "
                         "(or resume_from) to say where snapshots go")
    mega = bool(getattr(router, "mega", False))
    n_mod = env_step.n_obs_modalities
    if noise is None:
        noise = GeneratorNoise(e.seed, dev)
    if e.resume_from:
        tree, extra = _restore(
            e, _ckpt_template(e, router, params, noise, n_mod), dev)
        t_begin = int(extra["t"])
        carry, env = tree["carry"], tree["env"]
        snapshot = (tuple(tree["obs"]), tree.get("noise"))
    else:
        t_begin, snapshot = 0, None
        carry = None if mega else router.init_carry(e.n_cells, dev)
        env = batched.init_fluid_state(params, n_mod)
    ckpt = Checkpointer(ck_dir) if ck_dir else None
    traces, boundaries = [], ([t_begin] if t_begin else [])
    for t, n in _chunk_sizes(e, t_begin):
        carry, env, tr, snapshot = resumable_rollout(
            router, carry, env, env_step, n, noise, t_begin=t,
            snapshot=snapshot, n_total=e.n_windows if mega else None)
        traces.append(tr)
        if t + n < e.n_windows:
            boundaries.append(t + n)
            if ckpt is not None:
                ckpt.save(t + n, _ckpt_payload(carry, env, snapshot,
                                               sharded=False),
                          extra={"t": t + n, "scenario": e.scenario,
                                 "seed": e.seed})
    if ckpt is not None:
        ckpt.wait()
    return carry, env, _cat(traces), tuple(boundaries)


def _sharded_chunked(e: Experiment, router, params, env_step,
                     spec: ShardSpec, reducer: FleetMetricsReducer,
                     noise: Noise | None, dev: torch.device, mesh: list):
    """The checkpointed twin of a sharded run: chunks of
    :func:`~repro_torch.api.engine.sharded_resumable_rollout` between
    boundary-aligned windows, saving at every interior boundary the
    gathered router carry, env state and telemetry carry, the noise
    position and the reducer's raw stats (stacked on a leading shard
    axis).  The last chunk's stats are reduced as the uninterrupted run's
    are (:func:`~repro_torch.api.engine.sharded_finalize`).

    Returns (carry, env state, reduced stats, boundaries).
    """
    if e.checkpoint_every:
        engine_mod._check_boundary(router, int(e.checkpoint_every))
    ck_dir = e.checkpoint_dir or e.resume_from
    if e.checkpoint_every and not ck_dir:
        raise ValueError("checkpoint_every > 0 needs checkpoint_dir "
                         "(or resume_from) to say where snapshots go")
    mega = bool(getattr(router, "mega", False))
    n_mod = env_step.n_obs_modalities
    if noise is None:
        noise = GeneratorNoise(e.seed, dev)
    r_pad, r_local = spec.padded(e.n_cells, len(mesh))
    carry, snapshot, t_begin = None, None, 0
    env = batched.init_fluid_state(params, n_mod)
    if e.resume_from:
        stats = [reducer.init(r_local, d * r_local, "meta")
                 for d in range(len(mesh))]
        tmpl = _ckpt_template(e, router, params, noise, n_mod, r=r_pad)
        tmpl["stats"] = tuple(torch.stack(x) for x in zip(*stats))
        tree, extra = _restore(e, tmpl, dev)
        if extra.get("shards", len(mesh)) != len(mesh):
            raise ValueError(
                f"resume_from checkpoint was written by a run on "
                f"{extra['shards']} shards, this one has {len(mesh)}")
        t_begin = int(extra["t"])
        carry, env = tree["carry"], tree["env"]
        snapshot = (tuple(tree["obs"]), tree["stats"], tree.get("noise"))
    ckpt = Checkpointer(ck_dir) if ck_dir else None
    boundaries, stats = ([t_begin] if t_begin else []), None
    for t, n in _chunk_sizes(e, t_begin):
        carry, env, stats, snapshot = sharded_resumable_rollout(
            router, carry, env, env_step, n, noise, shard=spec,
            n_cells=e.n_cells, reducer=reducer, t_begin=t,
            snapshot=snapshot, n_total=e.n_windows if mega else None,
            mesh=mesh)
        if t + n < e.n_windows:
            boundaries.append(t + n)
            if ckpt is not None:
                ckpt.save(t + n, _ckpt_payload(carry, env, snapshot,
                                               sharded=True),
                          extra={"t": t + n, "scenario": e.scenario,
                                 "seed": e.seed, "shards": len(mesh)})
    if ckpt is not None:
        ckpt.wait()
    return (carry, env, sharded_finalize(stats, shard=spec, reducer=reducer),
            tuple(boundaries))


def _recovery_metrics(e: Experiment, info, res: RunResult,
                      control: RunResult) -> dict:
    """Recovery curve of a chaos run against its uninjured control.

    * ``time_to_recover_s``: windows after the fault clears until the
      fleet success rate is back within 95 % of the control's, in seconds
      (the horizon's remainder when it never is; ``recovered`` says which);
    * ``regret_vs_control``: mean per-window success-rate shortfall against
      the control (clipped at 0);
    * ``post_resume_forgetting``: mean drop in success rate across the
      run's resume boundaries (5 windows before minus 5 after); 0 when
      nothing resumed.
    """
    rate = _success_curve(res.trace)
    rate_c = _success_curve(control.trace)
    n = min(len(rate), len(rate_c))      # resumed runs trace a suffix only
    rate, rate_c = rate[-n:], rate_c[-n:]
    regret = float(np.maximum(rate_c - rate, 0.0).mean())

    t_end = int(np.ceil(info.fault_frac[1] * e.n_windows))
    i0 = max(t_end - (e.n_windows - n), 0)
    ok = rate[i0:] >= 0.95 * rate_c[i0:]
    recovered = bool(ok.any())
    ttr = int(np.argmax(ok)) if recovered else max(len(rate) - i0, 0)

    offset = e.n_windows - n
    w = 5
    drops = [float(rate[b - w:b].mean() - rate[b:b + w].mean())
             for b in (p - offset for p in res.resume_points)
             if b - w >= 0 and b + w <= n]
    return {
        "time_to_recover_s": float(ttr) * e.window_s,
        "recovered": recovered,
        "regret_vs_control": regret,
        "post_resume_forgetting": (float(np.mean(drops)) if drops else 0.0),
        "control_success_pct": control.success_pct,
        "watchdog_events": res.watchdog_events,
    }


def _success_curve(trace) -> np.ndarray:
    """(T,) fleet success rate per window from a trace."""
    s = trace.env.success.cpu().numpy().sum(axis=1)
    f = trace.env.failures.cpu().numpy().sum(axis=1)
    return s / np.maximum(s + f, _EPS)


# ------------------------------------------------------------------ comparison
@dataclasses.dataclass
class Comparison:
    """Results of a comparison grid, renderable as markdown or JSON."""

    results: list[RunResult]

    def markdown(self) -> str:
        """Table-1-style markdown: one row per (scenario, router)."""
        lines = [
            "| scenario | router | success % | P50 ms | P95 ms | "
            "tier share of success (light->heavy) | obs % | offload % |",
            "|---|---|---|---|---|---|---|---|",
        ]
        for res in self.results:
            share = "/".join(f"{100 * float(x):.0f}" for x in res.tier_share)
            lines.append(
                f"| {res.experiment.scenario} | {res.name} "
                f"| {res.success_pct:.1f} ± {res.success_std:.1f} "
                f"| {res.p50_ms:.0f} | {res.p95_ms:.0f} "
                f"| {share} | {100 * res.obs_frac:.0f} "
                f"| {100 * res.offload_frac:.1f} |")
        return "\n".join(lines)

    def to_json(self) -> dict:
        """{scenario: {router: summary}} nested metric dict.  Rows sharing
        (scenario, router name), e.g. one router at two seeds, get a ``#2``,
        ``#3`` ... suffix, so no row of the markdown table is dropped."""
        out: dict[str, dict] = {}
        for res in self.results:
            rows = out.setdefault(res.experiment.scenario, {})
            name, n = res.name, 1
            while name in rows:
                n += 1
                name = f"{res.name}#{n}"
            rows[name] = res.summary()
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    __str__ = markdown


def compare(experiments: Sequence[Experiment]) -> Comparison:
    """Run a list of experiments and collect them into a :class:`Comparison`.

    Experiments sharing (scenario, topology, R, T, seed) run against the
    same world schedules, so rows differ only by routing policy: the
    paper's Table-1 protocol at fleet scale.
    """
    return Comparison(results=[run(e) for e in experiments])


def table1_grid(routers: Sequence[str] = TABLE1_ROUTERS,
                scenario_names: Sequence[str] = ("paper-burst",
                                                 "flaky-telemetry"),
                **overrides) -> list[Experiment]:
    """The paper's comparison grid: every router on clean and degraded
    telemetry.  ``overrides`` go to every :class:`Experiment` (n_cells,
    n_windows, seed, topology, fused, device, ...)."""
    return [Experiment(router=r, scenario=s, **overrides)
            for s in scenario_names for r in routers]
