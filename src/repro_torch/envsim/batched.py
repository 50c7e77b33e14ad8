"""Batched discrete-time fluid engine for fleet-scale experiments.

A fluid (mean-flow) approximation of the edge testbed advanced one control
window at a time for every cell at once:

* per tier (any tier count K), request mass flows in at ``w_i · λ(t)`` and
  drains at the tier's service capacity ``c_i · μ_i``; the backlog (queued +
  in-flight mass) is one float per (cell, tier),
* queue caps convert excess backlog into ``overflow`` failures, down pods
  convert arrivals into ``refused`` failures, and saturation/shock restart
  hazards kill the backlog (``restart`` failures) and take the tier down,
* waiting time is backlog over capacity (Little's law), service variability
  enters through the lognormal P95 factor.

Telemetry validity: internals always advance on true flow; what a router
sees is ``WindowInfo.raw_obs`` + ``WindowInfo.obs_mask``.  A scenario's
(T, R, M) ``obs_valid`` schedule and/or ``restart_blackout`` (a down pod
emits nothing) zero per-modality mask entries, and masked modalities
re-emit the last *published* value.  With no degradation configured the
mask is all ones and ``raw_obs`` is the fresh telemetry.

Randomness is an operand: :func:`fluid_window_step` takes the two (R, K)
uniform arrays of the restart draw (fire, duration) instead of a key.
Fault injection: a scenario's (T, R, K) ``forced_down`` schedule takes
tiers administratively down (arrivals refused, in-system mass killed,
liveness probe down, independent of the restart machinery) and its
``speed`` schedule scales service speed (stragglers: capacity shrinks,
latency inflates, liveness stays).  Fleet graphs
(:class:`repro_torch.core.graph.FleetGraph`): the mass a cell rejects is
re-offered to its graph neighbors (cross-cell spillover) and each cell
publishes the mean pressure of its neighbors as a fifth telemetry column.
Every function is plain PyTorch over tensors with a leading cell axis R;
:func:`run_fluid` is a Python loop over windows.  A window is
:func:`fluid_flow` then :func:`fluid_publish`, joined by a
:class:`FlowMid` per cell: the spillover sits between the two, and the
whole-window kernel B3 runs a graph window's ticks as launches cut
there.

Sharded runs (:mod:`repro_torch.api.shard`) hold each shard's block of
rows of the padded fleet: ``row_block=(row_start, n_true, n_pad)`` cuts a
window's params and schedules to the block, and :func:`fluid_blocks_step`
advances every block of a tick at once, so on a graph world the
spillover's exchange reads every block's rejected mass and pressure
(:func:`block_exchange`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import GraphData, segment_sum
from repro_torch.device import resolve_device
from repro_torch.envsim.config import SimConfig

_EPS = 1e-9

# Telemetry modalities published per window: p95_s, rps, queue_depth, err.
N_OBS_MODALITIES = 4


class FluidParams(NamedTuple):
    """Static world description, broadcast over the cell axis R.

    Per-tier leaves are (R, K) float32 (lightest tier first); scalars are
    Python floats.  Build with :func:`params_from_config`.
    """

    servers: torch.Tensor            # (R, K) concurrent requests per tier
    mu: torch.Tensor                 # (R, K) per-server service rate (req/s)
    service_mean_s: torch.Tensor     # (R, K) mean service time
    service_p95_factor: torch.Tensor  # (R, K) lognormal P95 / mean ratio
    queue_cap: torch.Tensor          # (R, K) admission queue limit
    timeout_s: float                 # client timeout
    unstable: torch.Tensor           # (R, K) 1.0 where the tier can restart
    restart_base: torch.Tensor       # (R, K) spontaneous hazard (1/s)
    restart_load: torch.Tensor       # (R, K) hazard per unit util over knee
    restart_knee: torch.Tensor       # (R, K)
    restart_shock: torch.Tensor      # (R, K) hazard per (Δrps / capacity)
    restart_min_s: torch.Tensor      # (R, K)
    restart_max_s: torch.Tensor      # (R, K)
    latency_window_s: float          # observation EMA horizons
    error_window_s: float
    rps_window_s: float

    @property
    def n_cells(self) -> int:
        return self.servers.shape[0]

    @property
    def n_tiers(self) -> int:
        return self.servers.shape[1]


class FluidState(NamedTuple):
    """World state; every leaf carries the leading cell axis R."""

    backlog: torch.Tensor          # (R, K) request mass in system per tier
    down_left: torch.Tensor        # (R, K) seconds of downtime remaining
    util_accum: torch.Tensor       # (R, K) busy-fraction integral since scrape
    util_scrape: torch.Tensor      # (R, K) last published 10 s utilization
    prev_tier_rps: torch.Tensor    # (R, K) offered per-tier RPS last window
    p95_ema: torch.Tensor          # (R,) observed P95 (sliding-window approx)
    rps_ema: torch.Tensor          # (R,) observed offered RPS
    err_ema: torch.Tensor          # (R,) observed error rate
    held_obs: torch.Tensor         # (R, M) last *published* telemetry values
    # cumulative accounting (floats: request *mass*)
    n_requests: torch.Tensor       # (R,)
    n_success: torch.Tensor        # (R,)
    err_timeout: torch.Tensor      # (R,)
    err_overflow: torch.Tensor     # (R,)
    err_refused: torch.Tensor      # (R,)
    err_restart: torch.Tensor      # (R,)
    tier_requests: torch.Tensor    # (R, K)
    tier_success: torch.Tensor     # (R, K)
    n_restarts: torch.Tensor       # (R, K)


class WindowInfo(NamedTuple):
    """Per-window observables + diagnostics (what a router may see).

    The trailing ``spill_*`` / ``nbr_pressure`` fields are set only when
    the world has a fleet graph (cross-cell spillover); ungraphed runs
    carry None there.
    """

    raw_obs: torch.Tensor          # (R, M): p95_s, rps, queue_depth, err_rate
    obs_mask: torch.Tensor         # (R, M) 1 = fresh sample, 0 = stale/missing
    tier_utilization: torch.Tensor  # (R, K) 10 s scrape (paper §3)
    tier_up: torch.Tensor          # (R, K) liveness probe
    tier_queue: torch.Tensor       # (R, K) waiting mass per tier
    tier_latency_s: torch.Tensor   # (R, K) mean latency of this window's flow
    tier_p95_s: torch.Tensor       # (R, K)
    tier_completed: torch.Tensor   # (R, K) successful mass this window
    success: torch.Tensor          # (R,)
    failures: torch.Tensor         # (R,)
    restarted: torch.Tensor        # (R, K) 1.0 where a pod restarted
    spill_out: torch.Tensor | None = None       # (R,) mass sent to neighbors
    spill_in: torch.Tensor | None = None        # (R,) mass offered by them
    spill_admitted: torch.Tensor | None = None  # (R,) offered mass absorbed
    nbr_pressure: torch.Tensor | None = None    # (R,) mean neighbor pressure


class FluidResult(NamedTuple):
    """Aggregate per-cell outcome of a rollout (host-side numpy)."""

    n_requests: np.ndarray        # (R,)
    n_success: np.ndarray         # (R,)
    success_rate: np.ndarray      # (R,)
    error_breakdown: dict         # cause -> (R,)
    p95_ms: np.ndarray            # (R,) completion-weighted aggregate P95
    p50_ms: np.ndarray            # (R,)
    tier_requests: np.ndarray     # (R, K)
    tier_success: np.ndarray      # (R, K)
    n_restarts: np.ndarray        # (R, K)


# --------------------------------------------------------------------- build
def params_from_config(cfg: SimConfig,
                       n_cells: int,
                       capacity_scale: np.ndarray | None = None,
                       device: str | torch.device = "cuda") -> FluidParams:
    """FluidParams for ``n_cells`` replicas of the simulator's world.

    Args:
      cfg: the simulator configuration (tier count from ``len(cfg.tiers)``).
      n_cells: number of independent service cells R.
      capacity_scale: optional (R, K) per-cell multiplier on tier capacity.
      device: where the tensors live (``"cpu"`` for the plain path).
    """
    dev = resolve_device(device)

    def tiled(vals):
        return torch.tensor(np.tile(np.asarray(vals, np.float32),
                                    (n_cells, 1)), device=dev)

    tiers = cfg.tiers
    servers = np.tile(np.asarray([t.servers for t in tiers], np.float32),
                      (n_cells, 1))
    if capacity_scale is not None:
        servers = servers * np.asarray(capacity_scale, np.float32)
    # lognormal P95/mean ratio: exp(mu + 1.645 sigma) / exp(mu + sigma^2/2)
    p95f = []
    for t in tiers:
        sigma = np.sqrt(np.log(1.0 + t.service_cv ** 2))
        p95f.append(float(np.exp(1.645 * sigma - 0.5 * sigma ** 2)))
    inst = 1.0 if cfg.instability else 0.0
    return FluidParams(
        servers=torch.tensor(servers, device=dev),
        mu=tiled([1.0 / t.mean_service_s for t in tiers]),
        service_mean_s=tiled([t.mean_service_s for t in tiers]),
        service_p95_factor=tiled(p95f),
        queue_cap=tiled([t.queue_cap for t in tiers]),
        timeout_s=float(np.float32(cfg.timeout_s)),
        unstable=tiled([inst * float(t.unstable) for t in tiers]),
        restart_base=tiled([t.restart_base_hazard for t in tiers]),
        restart_load=tiled([t.restart_load_hazard for t in tiers]),
        restart_knee=tiled([t.restart_util_knee for t in tiers]),
        restart_shock=tiled([t.restart_shock_hazard for t in tiers]),
        restart_min_s=tiled([t.restart_min_s for t in tiers]),
        restart_max_s=tiled([t.restart_max_s for t in tiers]),
        latency_window_s=float(np.float32(cfg.latency_window_s)),
        error_window_s=float(np.float32(cfg.error_window_s)),
        rps_window_s=float(np.float32(cfg.rps_window_s)),
    )


def init_fluid_state(params: FluidParams,
                     n_modalities: int = N_OBS_MODALITIES) -> FluidState:
    """Zero state on the params' device."""
    r, k = params.n_cells, params.n_tiers
    dev = params.servers.device

    def z():
        return torch.zeros((r,), device=dev)

    def zt():
        return torch.zeros((r, k), device=dev)

    return FluidState(
        backlog=zt(), down_left=zt(), util_accum=zt(), util_scrape=zt(),
        prev_tier_rps=zt(), p95_ema=z(), rps_ema=z(), err_ema=z(),
        held_obs=torch.zeros((r, n_modalities), device=dev),
        n_requests=z(), n_success=z(), err_timeout=z(), err_overflow=z(),
        err_refused=z(), err_restart=z(), tier_requests=zt(),
        tier_success=zt(), n_restarts=zt(),
    )


def fluid_state_from_numpy(arrays: dict,
                           device: str | torch.device = "cuda") -> FluidState:
    """A :class:`FluidState` from the reference's leaves (a dict of numpy
    arrays keyed by field name)."""
    dev = resolve_device(device)
    return FluidState(**{k: torch.tensor(np.asarray(arrays[k]),
                                         dtype=torch.float32, device=dev)
                         for k in FluidState._fields})


def fluid_params_from_numpy(arrays: dict,
                            device: str | torch.device = "cuda"
                            ) -> FluidParams:
    """A :class:`FluidParams` from the reference's leaves (a dict of numpy
    arrays keyed by field name; the 0-d leaves become Python floats)."""
    dev = resolve_device(device)
    out = {}
    for k in FluidParams._fields:
        a = np.asarray(arrays[k], np.float32)
        out[k] = float(a) if a.ndim == 0 else torch.tensor(a, device=dev)
    return FluidParams(**out)


# ---------------------------------------------------------------------- step
def _weighted_p95(lat: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    """Completion-weighted 95th percentile of the K-atom tier latency mix
    ((..., K) atoms and masses -> (...))."""
    order = torch.argsort(lat, dim=-1, stable=True)
    lat_s = torch.gather(lat, -1, order)
    m_s = torch.gather(mass, -1, order)
    total = torch.clamp(torch.sum(m_s, dim=-1, keepdim=True), min=_EPS)
    cum = torch.cumsum(m_s, dim=-1) / total
    # first atom whose cumulative share reaches 0.95
    reach = cum >= 0.95
    first = reach & ~torch.cat(
        [torch.zeros_like(reach[..., :1]), reach[..., :-1]], dim=-1)
    return torch.sum(torch.where(first, lat_s, 0.0), dim=-1)


class FlowMid(NamedTuple):
    """A window's per-cell results that :func:`fluid_publish` reads from
    :func:`fluid_flow`: the rows kernel B3 leaves in its exchange buffer
    between the launches of a graph window (``enum Mid`` in
    ``csrc/mega_window.cu``).  ``rej``/``press`` are what the cell's graph
    neighbours read; the rest only the cell itself."""

    success: torch.Tensor          # (R,) completed mass
    over: torch.Tensor             # (R,) queue-cap overflow
    timed_out: torch.Tensor        # (R,)
    killed: torch.Tensor           # (R,) restart and admin-down kills
    arrived: torch.Tensor          # (R,) offered mass
    refused: torch.Tensor          # (R,) refused at down tiers
    p95: torch.Tensor              # (R,) completion-weighted P95 of the window
    cell_up: torch.Tensor | None   # (R,) bool: no tier down (blackout only)
    rej: torch.Tensor | None       # (R,) rejected mass (graph worlds)
    press: torch.Tensor | None     # (R,) in-system over live capacity (graph)


def _service(params: FluidParams, speed):
    """(per-server service rate, mean service time) under ``speed``."""
    if speed is None:
        return params.mu, params.service_mean_s
    sp = torch.clamp(speed.to(torch.float32), min=1e-3)
    return params.mu * sp, params.service_mean_s / sp


def _live(down_left: torch.Tensor, forced_down) -> torch.Tensor:
    """(R, K) bool: the tier is up (not restarting, not admin-down)."""
    up = down_left <= _EPS
    if forced_down is not None:
        up = up & (forced_down.to(torch.float32) <= 0.5)
    return up


def fluid_window_step(params: FluidParams,
                      state: FluidState,
                      weights: torch.Tensor,
                      arrival_rate: torch.Tensor,
                      hazard_scale: torch.Tensor,
                      uniforms: tuple[torch.Tensor, torch.Tensor],
                      t_idx: int,
                      dt: float = 1.0,
                      scrape_every: int = 10,
                      obs_valid: torch.Tensor | None = None,
                      restart_blackout: bool = False,
                      row_block: tuple | None = None,
                      forced_down: torch.Tensor | None = None,
                      speed: torch.Tensor | None = None,
                      graph=None) -> tuple[FluidState, WindowInfo]:
    """Advance every cell one control window under the given routing weights.

    Args:
      weights: (R, K) routing weights (normalized internally).
      arrival_rate: (R,) offered RPS this window.
      hazard_scale: (R, K) multiplier on the restart hazard this window.
      uniforms: ``(u_fire, u_dur)``, two (R, K) uniforms in [0, 1): the
        restart draw and the downtime-duration draw.
      t_idx: window index (drives the 10 s utilization scrape).
      dt: control-window length in seconds.
      scrape_every: windows between utilization scrapes.
      obs_valid: optional (R, M) 0/1 telemetry-validity mask this window.
      restart_blackout: a cell with any tier down publishes nothing.
      forced_down: optional (R, K) 0/1 injected downtime this window: the
        tier refuses arrivals, serves nothing, loses its in-system mass and
        probes as down, so an outage can outlive ``restart_max_s``.
      speed: optional (R, K) service-speed multiplier this window (<1
        shrinks capacity and inflates latency, the tier stays up).
      row_block: a shard's block ``(row_start, n_true, n_pad)`` of the
        padded fleet: ``state``, ``weights`` and ``uniforms`` hold its rows
        alone, while ``params`` and the schedules hold the whole padded
        fleet and are cut to the block here.  The restart uniforms come
        from the shard's view of the noise (drawn at the true R, phantom
        rows 1.0).  On a graph world the block must be the whole fleet (one
        shard); :func:`fluid_blocks_step` steps several.
      graph: optional :class:`repro_torch.core.graph.GraphData` — turns on
        cross-cell spillover: the mass a cell rejects this window (down-pod
        refusals and queue overflow) is re-offered to its out-neighbors
        (split 1/out_degree), pays the edge's hop latency and is admitted
        into whatever live headroom the receivers have whose estimated
        response still beats the timeout; the rest fails as overflow at the
        receiving side.  The per-cell sums over the edge list are gathers
        with a fixed-order reduction (no atomics).  Cells also publish a
        fifth telemetry column, the mean pressure of their out-neighbors.
        None runs the exact ungraphed program.

    The window is :func:`fluid_flow` then :func:`fluid_publish`, the two
    halves kernel B3 splits a graph window's ticks into.
    """
    if row_block is not None:
        params, arrival_rate, hazard_scale, obs_valid, forced_down, speed = \
            block_inputs(params, row_block, state.backlog,
                         (arrival_rate, hazard_scale, obs_valid, forced_down,
                          speed))
        if graph is not None and \
                state.backlog.shape[0] != graph.has_out.shape[0]:
            raise ValueError(
                "a graph world's spillover crosses row blocks: step every "
                "block of the tick at once with fluid_blocks_step")
    state, mid, tiers = fluid_flow(
        params, state, weights, arrival_rate, hazard_scale, uniforms, t_idx,
        dt=dt, scrape_every=scrape_every, restart_blackout=restart_blackout,
        forced_down=forced_down, speed=speed, spill=graph is not None)
    return fluid_publish(params, state, mid, tiers, arrival_rate, dt=dt,
                         obs_valid=obs_valid,
                         restart_blackout=restart_blackout,
                         forced_down=forced_down, speed=speed, graph=graph)


def fluid_flow(params: FluidParams, state: FluidState, weights: torch.Tensor,
               arrival_rate: torch.Tensor, hazard_scale: torch.Tensor,
               uniforms: tuple[torch.Tensor, torch.Tensor], t_idx: int, *,
               dt: float = 1.0, scrape_every: int = 10,
               restart_blackout: bool = False,
               forced_down: torch.Tensor | None = None,
               speed: torch.Tensor | None = None, spill: bool = False):
    """The first half of :func:`fluid_window_step`: arrivals, service,
    queue caps, restarts and fault schedules, up to what the cross-cell
    spillover reads (with ``spill``, on a graph world: each cell's
    rejected mass and pressure).

    Returns (state, :class:`FlowMid`, the window's per-tier
    :class:`WindowInfo` fields, the rest None): the state's per-tier leaves
    advance (the backlog before any spillover admission), its observables
    and cumulative per-cell counters are the publish step's.
    """
    w = torch.clamp(weights, min=0.0)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)

    up = _live(state.down_left, forced_down)          # (R, K) bool
    upf = up.to(torch.float32)
    mu_eff, service_mean = _service(params, speed)

    lam = w * arrival_rate[:, None]                   # (R, K) offered RPS
    arr = lam * dt                                    # (R, K) request mass
    refused = torch.sum(arr * (1.0 - upf), dim=-1)    # down pods 503 on arrival
    admitted = arr * upf

    cap_rate = params.servers * mu_eff                # (R, K) RPS at saturation
    cap = cap_rate * dt * upf
    backlog0 = state.backlog
    avail = backlog0 + admitted
    served = torch.minimum(avail, cap)
    backlog1 = avail - served

    # admission limit: waiting mass above queue_cap is rejected (HTTP 503)
    syscap = params.queue_cap + params.servers
    over = torch.clamp(backlog1 - syscap, min=0.0)
    backlog1 = backlog1 - over

    # Little's law: waiting time ≈ mean backlog over the window / drain rate
    wait = torch.where(cap_rate > 0,
                       0.5 * (backlog0 + backlog1)
                       / torch.clamp(cap_rate, min=_EPS), 0.0)
    tier_latency = wait + service_mean
    tier_p95 = wait + service_mean * params.service_p95_factor
    timed_out = torch.where(tier_latency > params.timeout_s, served, 0.0)
    completed = served - timed_out                    # (R, K) successes

    # utilization (busy-core fraction this window; down pods idle)
    util = torch.where(cap > 0,
                       served / torch.clamp(cap_rate * dt, min=_EPS), 0.0)
    util_accum = state.util_accum + util * dt
    scrape_now = ((t_idx + 1) % scrape_every) == 0
    if scrape_now:
        util_scrape = util_accum / (scrape_every * dt)
        util_accum = torch.zeros_like(util_accum)
    else:
        util_scrape = state.util_scrape

    # restart hazard (same functional form as the event simulator)
    rps_delta = lam - state.prev_tier_rps
    hazard = hazard_scale * params.unstable * (
        params.restart_base
        + params.restart_load * torch.clamp(
            util_scrape - params.restart_knee, min=0.0)
        + params.restart_shock * torch.clamp(rps_delta, min=0.0)
        / torch.clamp(cap_rate, min=_EPS))
    p_restart = 1.0 - torch.exp(-hazard * dt)
    u, dur_u = uniforms
    restarted = (up & (u < p_restart)).to(torch.float32)
    killed = backlog1 * restarted                     # in-system mass dies
    backlog2 = backlog1 * (1.0 - restarted)
    if forced_down is not None:
        # injected downtime strands the tier's in-system mass too (a restart
        # cannot fire on an admin-down tier, so nothing is counted twice)
        adminf = forced_down.to(torch.float32)
        killed = killed + backlog2 * adminf
        backlog2 = backlog2 * (1.0 - adminf)
    dur = params.restart_min_s + dur_u * (
        params.restart_max_s - params.restart_min_s)
    down_left = torch.clamp(state.down_left - dt, min=0.0)
    down_left = torch.where(restarted > 0, dur, down_left)

    over_sum = torch.sum(over, dim=-1)
    live = _live(down_left, forced_down)              # post-restart liveness
    cell_up = rej = press = None
    if restart_blackout:
        cell_up = torch.all(live, dim=-1)             # (R,) bool
        # the utilization scrape endpoint is down too: re-publish the last
        # scrape instead of leaking live state from a dark pod
        util_scrape = torch.where(cell_up[:, None], util_scrape,
                                  state.util_scrape)
    if spill:
        rej = refused + over_sum                      # (R,) rejected mass
        # cell pressure: in-system mass over live system capacity (fully
        # down cells saturate the clip)
        press = torch.clamp(
            torch.sum(backlog2, dim=-1)
            / torch.clamp(torch.sum(syscap * live.to(torch.float32), dim=-1),
                          min=_EPS),
            max=1e3)
    mid = FlowMid(success=torch.sum(completed, dim=-1), over=over_sum,
                  timed_out=torch.sum(timed_out, dim=-1),
                  killed=torch.sum(killed, dim=-1),
                  arrived=torch.sum(arr, dim=-1), refused=refused,
                  p95=_weighted_p95(tier_p95, completed), cell_up=cell_up,
                  rej=rej, press=press)
    tier_up = (down_left <= _EPS).to(torch.float32)
    if forced_down is not None:
        tier_up = tier_up * (1.0 - adminf)
    tiers = WindowInfo(
        raw_obs=None, obs_mask=None, tier_utilization=util_scrape,
        tier_up=tier_up, tier_queue=None, tier_latency_s=tier_latency,
        tier_p95_s=tier_p95, tier_completed=completed, success=None,
        failures=None, restarted=restarted)
    state = state._replace(
        backlog=backlog2, down_left=down_left, util_accum=util_accum,
        util_scrape=util_scrape, prev_tier_rps=lam,
        tier_requests=state.tier_requests + arr,
        tier_success=state.tier_success + completed,
        n_restarts=state.n_restarts + restarted)
    return state, mid, tiers


def block_inputs(params: FluidParams, row_block: tuple, like: torch.Tensor,
                 per_cell: tuple, axis: int = 0) -> tuple:
    """``params`` and the per-cell tensors of ``per_cell`` (each with the
    padded fleet on ``axis``; None passes through) cut to ``row_block``'s
    rows, as many as ``like`` has, on ``like``'s device.  Returns (params,
    *per_cell)."""
    row0, n = row_block[0], like.shape[0]
    dev = like.device

    def rows(x, ax):
        return None if x is None else x.narrow(ax, row0, n).to(dev)

    params = FluidParams(*(rows(x, 0) if isinstance(x, torch.Tensor) else x
                           for x in params))
    return (params,) + tuple(rows(x, axis) for x in per_cell)


def block_exchange(mids: list[FlowMid], graph, row_blocks: list) -> list:
    """The spillover's exchange over row blocks: for each block,
    (spill_in, hop_mass, nbr_press, has_out) on its rows.

    The blocks' rejected mass and pressure are gathered in shard order
    (the blocks are contiguous, so that is the padded fleet's cell axis)
    onto the graph's device, the three segment sums of
    :func:`spill_exchange` run at the global R in their fixed order, and
    their outputs and ``has_out`` are cut back to each block.  One block
    holds the whole fleet and needs no gather.
    """
    if len(mids) == 1:
        return [spill_exchange(mids[0], graph) + (graph.has_out,)]
    dev = graph.has_out.device
    whole = mids[0]._replace(rej=torch.cat([m.rej.to(dev) for m in mids]),
                             press=torch.cat([m.press.to(dev) for m in mids]))
    sums = spill_exchange(whole, graph) + (graph.has_out,)
    out = []
    for m, rb in zip(mids, row_blocks):
        n, d = m.rej.shape[0], m.rej.device
        out.append(tuple(x[rb[0]:rb[0] + n].to(d) for x in sums))
    return out


def spill_exchange(mid: FlowMid, graph) -> tuple:
    """(spill_in, hop_mass, nbr_press), each (R,): the mass each cell's
    in-neighbours offer it (their rejected mass split 1/out-degree), that
    mass times each edge's hop latency, and the mean pressure of its
    out-neighbours, summed along the padded edge lists in edge order."""
    offer = mid.rej[graph.src] * graph.share          # (E,) per-edge offer
    return (segment_sum(offer, graph.in_edges),
            segment_sum(offer * graph.hop, graph.in_edges),
            segment_sum(mid.press[graph.dst] * graph.share,
                        graph.out_edges))


def fluid_publish(params: FluidParams, state: FluidState, mid: FlowMid,
                  tiers: WindowInfo, arrival_rate: torch.Tensor, *,
                  dt: float = 1.0, obs_valid: torch.Tensor | None = None,
                  restart_blackout: bool = False,
                  forced_down: torch.Tensor | None = None,
                  speed: torch.Tensor | None = None,
                  graph=None, exchange=None) -> tuple[FluidState, WindowInfo]:
    """The second half of :func:`fluid_window_step`, from
    :func:`fluid_flow`'s state, :class:`FlowMid` and per-tier fields: the
    spillover on a graph world (its exchange over every cell's ``mid``, or
    a row block's part of one from :func:`block_exchange` as
    ``exchange``), the queues, the observation EMAs, the telemetry mask
    and stale hold, and the accounting."""
    # ---- cross-cell spillover (graph worlds only) -------------------------
    # Fleet-global request mass is conserved: Σ requests == Σ success +
    # Σ every failure cause + Σ final backlog.
    backlog2 = state.backlog
    spill_out = spill_in = spill_admitted = nbr_press = None
    if graph is not None:
        mu_eff, service_mean = _service(params, speed)
        cap_rate = params.servers * mu_eff
        syscap = params.queue_cap + params.servers
        up2f = _live(state.down_left, forced_down).to(torch.float32)
        if exchange is None:
            exchange = spill_exchange(mid, graph) + (graph.has_out,)
        spill_in, hop_mass, nbr_press, has_out = exchange
        hop_mean = hop_mass / torch.clamp(spill_in, min=_EPS)     # (R,)
        est_resp = (hop_mean[:, None]
                    + backlog2 / torch.clamp(cap_rate, min=_EPS)
                    + service_mean)                               # (R, K)
        viable = (est_resp <= params.timeout_s).to(torch.float32) * up2f
        room = torch.clamp(syscap - backlog2, min=0.0) * viable   # (R, K)
        room_tot = torch.sum(room, dim=-1)
        spill_admitted = torch.minimum(spill_in, room_tot)        # (R,)
        admit = room * (spill_admitted
                        / torch.clamp(room_tot, min=_EPS))[:, None]
        spill_dropped = spill_in - spill_admitted
        backlog2 = backlog2 + admit
        keep = 1.0 - has_out          # exporters keep none of their rejects
        spill_out = mid.rej * has_out

    # ---- accounting -------------------------------------------------------
    win_success = mid.success
    if graph is None:
        win_fail = mid.refused + mid.over + mid.timed_out + mid.killed
        err_refused_new = state.err_refused + mid.refused
        err_overflow_new = state.err_overflow + mid.over
    else:
        win_fail = (mid.refused * keep + mid.over * keep + spill_dropped
                    + mid.timed_out + mid.killed)
        err_refused_new = state.err_refused + mid.refused * keep
        err_overflow_new = (state.err_overflow + mid.over * keep
                            + spill_dropped)

    # ---- router observables (EMA ≈ the event sim's sliding windows) -------
    a_lat = min(1.0, 2.0 * dt / params.latency_window_s)
    a_err = min(1.0, 2.0 * dt / params.error_window_s)
    a_rps = min(1.0, 2.0 * dt / params.rps_window_s)

    any_done = win_success > _EPS
    p95_ema = torch.where(any_done,
                          (1 - a_lat) * state.p95_ema + a_lat * mid.p95,
                          state.p95_ema)
    total_win = win_success + win_fail
    err_frac = win_fail / torch.clamp(total_win, min=_EPS)
    err_ema = torch.where(total_win > _EPS,
                          (1 - a_err) * state.err_ema + a_err * err_frac,
                          state.err_ema)
    rps_ema = (1 - a_rps) * state.rps_ema + a_rps * arrival_rate
    tier_queue = torch.clamp(backlog2 - params.servers, min=0.0)   # (R, K)
    queue_depth = torch.sum(tier_queue, dim=-1)

    # ---- telemetry pipeline (validity mask + stale-hold emission) ---------
    obs_cols = [p95_ema, rps_ema, queue_depth, err_ema]
    if nbr_press is not None:
        # graph worlds publish the mean out-neighbor pressure as a fifth
        # column (same mask / stale-hold pipeline as the rest)
        obs_cols.append(nbr_press)
    fresh_obs = torch.stack(obs_cols, dim=-1)
    if obs_valid is None and not restart_blackout:
        obs_mask = torch.ones_like(fresh_obs)
        published = fresh_obs
    else:
        obs_mask = (torch.ones_like(fresh_obs) if obs_valid is None
                    else obs_valid.to(torch.float32))
        if restart_blackout:
            # a cell with a tier down (restarting or admin-down) emits
            # nothing
            obs_mask = obs_mask * mid.cell_up[:, None].to(torch.float32)
        # a masked gauge holds its last published value (stale replay)
        published = torch.where(obs_mask > 0, fresh_obs, state.held_obs)

    new_state = state._replace(
        backlog=backlog2,
        p95_ema=p95_ema,
        rps_ema=rps_ema,
        err_ema=err_ema,
        held_obs=published,
        n_requests=state.n_requests + mid.arrived,
        n_success=state.n_success + win_success,
        err_timeout=state.err_timeout + mid.timed_out,
        err_overflow=err_overflow_new,
        err_refused=err_refused_new,
        err_restart=state.err_restart + mid.killed,
    )
    info = tiers._replace(
        raw_obs=published,
        obs_mask=obs_mask,
        tier_queue=tier_queue,
        success=win_success,
        failures=win_fail,
        spill_out=spill_out,
        spill_in=spill_in,
        spill_admitted=spill_admitted,
        nbr_pressure=nbr_press,
    )
    return new_state, info


def fluid_blocks_step(params: FluidParams, states: list, weights: list,
                      arrival_rate: torch.Tensor, hazard_scale: torch.Tensor,
                      uniforms: list, t_idx: int, row_blocks: list, *,
                      dt: float = 1.0, scrape_every: int = 10,
                      obs_valid: torch.Tensor | None = None,
                      restart_blackout: bool = False,
                      forced_down: torch.Tensor | None = None,
                      speed: torch.Tensor | None = None,
                      graph=None) -> tuple[list, list]:
    """One window of every row block of a sharded fleet.

    ``states``, ``weights`` and ``uniforms`` hold one entry per block (its
    rows, on its device), ``row_blocks`` the blocks ``(row_start, n_true,
    n_pad)`` in shard order; params and schedules hold the whole padded
    fleet, as for :func:`fluid_window_step`.  On a graph world every block
    runs :func:`fluid_flow`, the exchange runs over all of them
    (:func:`block_exchange`), then every block runs
    :func:`fluid_publish`.  Returns (states, WindowInfos), one per block.
    """
    if graph is None or len(states) == 1:
        outs = [fluid_window_step(
            params, st, w, arrival_rate, hazard_scale, u, t_idx, dt=dt,
            scrape_every=scrape_every, obs_valid=obs_valid,
            restart_blackout=restart_blackout, row_block=rb,
            forced_down=forced_down, speed=speed, graph=graph)
            for st, w, u, rb in zip(states, weights, uniforms, row_blocks)]
        return [o[0] for o in outs], [o[1] for o in outs]
    flows = []
    for st, w, u, rb in zip(states, weights, uniforms, row_blocks):
        p, arr, haz, ov, fd, sp = block_inputs(
            params, rb, st.backlog,
            (arrival_rate, hazard_scale, obs_valid, forced_down, speed))
        st, mid, tiers = fluid_flow(
            p, st, w, arr, haz, u, t_idx, dt=dt, scrape_every=scrape_every,
            restart_blackout=restart_blackout, forced_down=fd, speed=sp,
            spill=True)
        flows.append((p, st, mid, tiers, arr, ov, fd, sp))
    exchanges = block_exchange([f[2] for f in flows], graph, row_blocks)
    outs = [fluid_publish(p, st, mid, tiers, arr, dt=dt, obs_valid=ov,
                          restart_blackout=restart_blackout, forced_down=fd,
                          speed=sp, graph=graph, exchange=x)
            for (p, st, mid, tiers, arr, ov, fd, sp), x in zip(flows,
                                                               exchanges)]
    return [o[0] for o in outs], [o[1] for o in outs]


def stack_infos(infos: list) -> WindowInfo:
    """Stack per-window :class:`WindowInfo` records along a new T axis
    (fields that are None in every record stay None)."""
    return WindowInfo(*(None if f[0] is None else torch.stack(f)
                        for f in zip(*infos)))


# ------------------------------------------------------------------ rollouts
def run_fluid(params: FluidParams,
              arrival_rate: torch.Tensor,
              hazard_scale: torch.Tensor,
              weights: torch.Tensor,
              noise,
              dt: float = 1.0,
              scrape_every: int = 10,
              obs_valid: torch.Tensor | None = None,
              restart_blackout: bool = False,
              forced_down: torch.Tensor | None = None,
              speed: torch.Tensor | None = None
              ) -> tuple[FluidState, WindowInfo]:
    """Static-router rollout: a loop over T windows.

    Args:
      arrival_rate: (T, R) offered RPS schedule.
      hazard_scale: (T, R, K) restart-hazard multiplier schedule.
      weights: (K,), (R, K) or (T, R, K) routing weights.
      noise: a :class:`repro_torch.noise.Noise` source of the restart
        uniforms (``env_uniforms(t, (R, K))``).
      obs_valid: optional (T, R, M) telemetry-validity schedule.
      forced_down / speed: optional (T, R, K) fault schedules.

    Returns:
      (final FluidState, stacked WindowInfo traces with leading T axis).
    """
    t_total = arrival_rate.shape[0]
    r, k = params.n_cells, params.n_tiers
    if weights.ndim == 1:
        weights = weights[None].expand(r, k)
    if weights.ndim == 2:
        weights = weights[None].expand(t_total, r, k)
    state = init_fluid_state(params)
    infos = []
    for t in range(t_total):
        state, info = fluid_window_step(
            params, state, weights[t], arrival_rate[t], hazard_scale[t],
            noise.env_uniforms(t, (r, k)), t, dt=dt,
            scrape_every=scrape_every,
            obs_valid=None if obs_valid is None else obs_valid[t],
            restart_blackout=restart_blackout,
            forced_down=None if forced_down is None else forced_down[t],
            speed=None if speed is None else speed[t])
        infos.append(info)
    return state, stack_infos(infos)


class FluidIngredients(NamedTuple):
    """Everything :func:`make_env_step` closes over, as data.

    The whole-window (mega) engine path advances a full slow period per
    launch and needs the schedules as slices, not one-row lookups; it
    reads these from ``env_step.fluid`` so it drives exactly the same
    world (params, schedules, mask semantics) as the per-tick engine.
    """

    params: FluidParams
    arrival_rate: torch.Tensor         # (T, R)
    hazard_scale: torch.Tensor         # (T, R, K)
    dt: float
    scrape_every: int
    obs_valid: torch.Tensor | None     # (T, R, M) or None
    restart_blackout: bool
    forced_down: torch.Tensor | None = None   # (T, R, K) or None
    speed: torch.Tensor | None = None         # (T, R, K) or None
    graph: GraphData | None = None            # edge tensors or None


def make_env_step(params: FluidParams,
                  arrival_rate: torch.Tensor,
                  hazard_scale: torch.Tensor,
                  dt: float = 1.0,
                  scrape_every: int = 10,
                  obs_valid: torch.Tensor | None = None,
                  restart_blackout: bool = False,
                  forced_down: torch.Tensor | None = None,
                  speed: torch.Tensor | None = None,
                  graph=None) -> Callable:
    """Adapt the fluid engine to the closed-loop engine.

    Returns ``env_step(env_state, weights, t_idx, uniforms, row_block=None)
    -> (env_state, WindowInfo)`` over the scenario schedules.  The
    closure's ``emits_mask`` tells mask-aware consumers whether degradation
    is configured, ``n_obs_modalities`` the telemetry width and ``fluid``
    the :class:`FluidIngredients` for whole-window consumers.  It is
    shard-aware (``supports_shard``): ``row_block`` steps one shard's
    rows, and ``env_step.step_blocks(states, weights, t_idx, uniforms,
    row_blocks)`` steps every shard of a tick (:func:`fluid_blocks_step`).

    ``graph``: a :class:`repro_torch.core.graph.FleetGraph` built at the
    fleet size turns on cross-cell spillover and the neighbor-pressure
    column.  The closure then has ``has_graph = True`` and
    ``n_obs_modalities = 5``, and a 4-column ``obs_valid`` schedule grows
    an always-valid neighbor column.  ``graph=None`` or an empty edge list
    runs the exact ungraphed program.
    """
    dev = params.servers.device
    arrival_rate = torch.as_tensor(arrival_rate, dtype=torch.float32,
                                   device=dev)
    hazard_scale = torch.as_tensor(hazard_scale, dtype=torch.float32,
                                   device=dev)
    def schedule(x):
        return (None if x is None else
                torch.as_tensor(x, dtype=torch.float32, device=dev))

    obs_valid, forced_down, speed = (schedule(x) for x in
                                     (obs_valid, forced_down, speed))
    gd = None if graph is None else graph.device_data(params.n_cells, dev)
    if (gd is not None and obs_valid is not None
            and obs_valid.shape[-1] == N_OBS_MODALITIES):
        # the neighbor pressure is engine-internal, not scraped telemetry:
        # degradation schedules leave it always valid
        obs_valid = torch.cat(
            [obs_valid, torch.ones(obs_valid.shape[:-1] + (1,), device=dev)],
            dim=-1)

    def at(x, t_idx):
        return None if x is None else x[t_idx]

    def env_step(env_state, weights, t_idx, uniforms, row_block=None):
        return fluid_window_step(params, env_state, weights,
                                 arrival_rate[t_idx], hazard_scale[t_idx],
                                 uniforms, t_idx, dt=dt,
                                 scrape_every=scrape_every,
                                 obs_valid=at(obs_valid, t_idx),
                                 restart_blackout=restart_blackout,
                                 row_block=row_block,
                                 forced_down=at(forced_down, t_idx),
                                 speed=at(speed, t_idx), graph=gd)

    def step_blocks(states, weights, t_idx, uniforms, row_blocks):
        return fluid_blocks_step(params, states, weights,
                                 arrival_rate[t_idx], hazard_scale[t_idx],
                                 uniforms, t_idx, row_blocks, dt=dt,
                                 scrape_every=scrape_every,
                                 obs_valid=at(obs_valid, t_idx),
                                 restart_blackout=restart_blackout,
                                 forced_down=at(forced_down, t_idx),
                                 speed=at(speed, t_idx), graph=gd)

    env_step.supports_shard = True
    env_step.step_blocks = step_blocks
    env_step.emits_mask = obs_valid is not None or restart_blackout
    env_step.has_graph = gd is not None
    env_step.n_obs_modalities = N_OBS_MODALITIES + (gd is not None)
    env_step.fluid = FluidIngredients(
        params=params, arrival_rate=arrival_rate, hazard_scale=hazard_scale,
        dt=dt, scrape_every=scrape_every, obs_valid=obs_valid,
        restart_blackout=restart_blackout, forced_down=forced_down,
        speed=speed, graph=gd)
    return env_step


def make_scenario_env_step(params: FluidParams, sc, dt: float = 1.0,
                           scrape_every: int = 10, graph=None) -> Callable:
    """:func:`make_env_step` from a compiled
    :class:`~repro_torch.envsim.scenarios.ScenarioBatch`, unpacking every
    schedule so a call site cannot drop a scenario's degradation."""
    return make_env_step(params, sc.arrival_rate, sc.hazard_scale, dt=dt,
                         scrape_every=scrape_every, obs_valid=sc.obs_valid,
                         restart_blackout=sc.restart_blackout,
                         forced_down=sc.forced_down, speed=sc.speed,
                         graph=graph)


def summarize(final: FluidState, trace: WindowInfo) -> FluidResult:
    """Host-side aggregation of a rollout into per-cell Table-1-style stats."""
    lat = trace.tier_p95_s.cpu().numpy()            # (T, R, K)
    mean_lat = trace.tier_latency_s.cpu().numpy()
    mass = trace.tier_completed.cpu().numpy()
    t, r, k = lat.shape
    lat_flat = np.moveaxis(lat, 1, 0).reshape(r, t * k)
    mean_flat = np.moveaxis(mean_lat, 1, 0).reshape(r, t * k)
    mass_flat = np.moveaxis(mass, 1, 0).reshape(r, t * k)
    p95 = np.zeros(r)
    p50 = np.zeros(r)
    for i in range(r):
        total = mass_flat[i].sum()
        if total <= 0:
            continue
        order95 = np.argsort(lat_flat[i])
        cum = np.cumsum(mass_flat[i][order95]) / total
        p95[i] = lat_flat[i][order95][np.searchsorted(cum, 0.95)
                                      .clip(0, t * k - 1)]
        order50 = np.argsort(mean_flat[i])
        cum50 = np.cumsum(mass_flat[i][order50]) / total
        p50[i] = mean_flat[i][order50][np.searchsorted(cum50, 0.50)
                                       .clip(0, t * k - 1)]

    def host(x):
        return x.cpu().numpy()

    n_req = host(final.n_requests)
    n_succ = host(final.n_success)
    return FluidResult(
        n_requests=n_req,
        n_success=n_succ,
        success_rate=n_succ / np.maximum(n_req, _EPS),
        error_breakdown={
            "timeout": host(final.err_timeout),
            "overflow": host(final.err_overflow),
            "refused": host(final.err_refused),
            "restart": host(final.err_restart),
        },
        p95_ms=1000.0 * p95,
        p50_ms=1000.0 * p50,
        tier_requests=host(final.tier_requests),
        tier_success=host(final.tier_success),
        n_restarts=host(final.n_restarts),
    )
