"""Wrapper of the whole-window kernel B3 (``csrc/mega_window.cu``).

:func:`mega_window_cuda` replaces the reference's Pallas megakernel
``repro/kernels/efe/mega.py::mega_window_pallas``: one launch advances
every router of the fleet through W fused fast ticks.  It takes the
arguments and returns the results of the plain PyTorch version
:func:`repro_torch.core.mega.mega_window`, which is what
:func:`repro_torch.kernels.efe.ops.mega_window` runs for CPU tensors.

The wrapper checks device, dtype, shape and contiguity, packs the operands
as the Pallas kernel stacks them — the per-tier params ``pstack``
(12, R, K), the env carries ``envk`` (8, R, K) and ``envr`` (R, 9), the
telemetry ``obsm`` (3, R, M) and the trace outputs (W, 8, R, K),
(W, 4, R), (W, 3, R, M) — launches on the current stream and raises on a
non-zero return.  The Pallas stack's four scalar rows (timeout and the
three EMA windows) are plain floats in the port's
:class:`~repro_torch.envsim.batched.FluidParams`, so they travel as scalars.
The ~40 operands travel as one :class:`MegaArgs` structure of device
pointers, mirrored by ``struct MegaArgs`` in the CUDA source.

A warm-promoted fleet (``state.cache.b_base`` set) passes its dense
(R, A, S, S) baseline and runs the kernel's warm instantiation; a fresh
fleet passes a null pointer and runs the fresh one.  Fault schedules
(``forced_down``/``speed``, (W, R, K)) go in as two more operands (null
without them).  A fleet graph passes its edge tensors and a (2, R, 10)
exchange buffer, and its window runs as W + 1 launches over one tick each
(the cross-cell spillover needs every cell's flow of a tick before any
cell can publish it); the telemetry is then M=5 wide and the trace's
``spill_*``/``nbr_pressure`` fields are set.  A sharded fleet's row
blocks (:func:`mega_window_blocks_cuda`) launch over their own rows; on a
graph the exchange buffer and the edge lists are indexed by global row,
with the block's first row and the padded fleet size as launch arguments,
and the blocks' launches interleave.  The slot pushes go in
place into the caller's tape at columns ``[t0, t0 + W)``; every other
output is a new tensor.  The kernel draws
nothing: the Gumbel noise and the restart uniforms are operands.  Every
launch is counted in ``mega_window_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import belief as belief_mod
from repro_torch.core import mega as mega_core
from repro_torch.core import policies, preferences, spaces
from repro_torch.envsim import batched
from repro_torch.kernels import build
from repro_torch.kernels.efe.efe import _check, _ptr, _raise_on

SOURCES = ("mega_window.cu",)
#: Plain multiplies and adds round one at a time, as PyTorch's elementwise
#: kernels do; contracting them into FMAs would move the env's restart and
#: timeout thresholds by an ulp against the plain version.
EXTRA_FLAGS = ("-fmad=false",)
#: Kernel limits: S <= 4·256 states and A·(P+1) <= 4·256 EFE accumulators
#: (four per thread of the 256-thread block), K and M at most 8.
MAX_S, MAX_ACC, MAX_KM = 1024, 1024, 8
#: Floats a router leaves in the exchange buffer per graph tick (``enum
#: Mid`` in the CUDA source).
N_MID = 10

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class MegaArgs(ctypes.Structure):
    """Mirror of ``struct MegaArgs`` in ``csrc/mega_window.cu``."""

    _fields_ = (
        [(n, _P) for n in (
            "q_prev", "q_next", "slot_bins", "slot_mask", "slot_action",
            "slot_dt",
            "colsum", "proj", "projsum", "qnproj", "sumqn", "coefact",
            "logna", "b_base",
            "belief", "prev_action", "scal", "t",
            "obsm", "tier_util", "envk", "envr", "pstack",
            "arrival", "hazard", "obs_valid", "uniforms", "gumbel",
            "sf_tbl", "logc", "cost", "ptable", "obs_edges", "n_edges",
            "util_edges",
            "tr_act", "tr_rk", "tr_r", "tr_rm",
            "forced_down", "speed", "g_src", "g_dst", "g_share", "g_hop",
            "g_has_out", "g_in", "g_out", "xch", "tr_g")]
        + [(n, _I) for n in (
            "R", "J", "S", "A", "M", "NB", "K", "W", "P", "E",
            "n_util_edges", "n_used", "t0", "dwell", "util_period",
            "scrape_every", "err_ix", "emits_mask", "masked_obs",
            "restart_blackout", "bf16_slots", "G_E", "G_din", "G_dout",
            "G_R", "row0", "w_lo", "w_hi")]
        + [(n, _F) for n in (
            "dt", "fast_period_s", "err_decay", "err_keep", "error_trigger",
            "beta", "u_c", "d_c", "usd", "log_match", "log_miss",
            "timeout_s", "a_lat", "a_err", "a_rps", "keep_lat", "keep_err",
            "keep_rps", "scrape_den")])


def library() -> ctypes.CDLL:
    """The compiled kernel library (built on first use)."""
    lib = build.load("mega_window", SOURCES, EXTRA_FLAGS)
    lib.mega_window_launch.argtypes = [ctypes.POINTER(MegaArgs), _P]
    lib.mega_window_launch.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _tables(cfg, disc, util_edges: tuple, device: torch.device) -> dict:
    """The shared model tables the kernel reads, once per configuration."""
    topo = cfg.topology
    k = topo.n_tiers
    logc_nom, logc_uns = preferences.preference_log_tables(cfg, device)
    edges = disc.modality_edges()
    eps = belief_mod.UTIL_SCRAPE_EPS
    logs = torch.log(torch.tensor([1.0 - eps, eps / (topo.n_levels - 1)]))
    return dict(
        sf_tbl=torch.tensor(spaces.state_factor_table(topo)[:, 2:2 + k],
                            dtype=torch.int32, device=device).contiguous(),
        logc=torch.stack([logc_nom, logc_uns]).contiguous(),
        cost=(cfg.cost_weight
              * policies.policy_concentration_cost(topo, device)).contiguous(),
        ptable=policies.policy_table(topo, device).contiguous(),
        obs_edges=disc.as_padded_edges(device).contiguous(),
        n_edges=torch.tensor([len(e) for e in edges], dtype=torch.int32,
                             device=device),
        util_edges=torch.tensor(util_edges, dtype=torch.float32,
                                device=device),
        log_match=float(logs[0]), log_miss=float(logs[1]),
        n_edge_cols=max(len(e) for e in edges))


def mega_window_cuda(state, est, obs_carry, params,
                     arrival: torch.Tensor, hazard: torch.Tensor,
                     obs_valid: torch.Tensor | None, uniforms: torch.Tensor,
                     gumbel: torch.Tensor, t0: int, *,
                     cfg, disc, util_edges, util_period: int, dt: float,
                     scrape_every: int, restart_blackout: bool,
                     emits_mask: bool, forced_down=None, speed=None,
                     row_block=None, graph=None):
    """Kernel B3: W fused fast ticks for the whole fleet in one launch.

    Arguments and results as :func:`repro_torch.core.mega.mega_window`.
    ``t0`` must sit on a dwell boundary and the window must fit the tape
    (``t0 + W <= J``).  Raises for non-CUDA tensors.  A graph window is
    W + 1 launches.  A row block launches over the block's rows with its
    operands cut to them; on a graph the block must be the whole fleet
    (several blocks: :func:`mega_window_blocks_cuda`).
    """
    params, arrival, hazard, obs_valid, forced_down, speed = \
        mega_core.block_window(
            state, params, (arrival, hazard, obs_valid, forced_down, speed),
            row_block, graph)
    packed = _pack(state, est, obs_carry, params, arrival, hazard, obs_valid,
                   uniforms, gumbel, t0, cfg=cfg, disc=disc,
                   util_edges=util_edges, util_period=util_period, dt=dt,
                   scrape_every=scrape_every,
                   restart_blackout=restart_blackout, emits_mask=emits_mask,
                   forced_down=forced_down, speed=speed, graph=graph)
    w = gumbel.shape[0]
    # a graph window: launch i publishes tick i - 1 and runs tick i
    ranges = ([(0, w)] if graph is None
              else [(i, min(i + 1, w)) for i in range(w + 1)])
    for lo, hi in ranges:
        _launch(packed, lo, hi)
    return _unpack(packed)


def mega_window_blocks_cuda(blocks: list, params, arrival: torch.Tensor,
                            hazard: torch.Tensor,
                            obs_valid: torch.Tensor | None, t0: int, *,
                            cfg, disc, util_edges, util_period: int,
                            dt: float, scrape_every: int,
                            restart_blackout: bool, emits_mask: bool,
                            forced_down=None, speed=None, graph=None):
    """Kernel B3 on every row block of a sharded fleet.

    Arguments and results as
    :func:`repro_torch.core.mega.mega_window_blocks`.  Without a graph, or
    with one block, each block is one :func:`mega_window_cuda` call on
    its rows.  On a graph the blocks' launches interleave: launch i of
    every block before launch i + 1 of any, each block's kernel reading
    and writing the exchange buffer (2, R_pad, 10) by global row, with its
    first row and R_pad as launch arguments.  Blocks on one device share
    one buffer and run in order on its stream; with several devices each
    has its own, and after each launch every block's rows of the tick it
    wrote are copied into the other devices' buffers, in shard order.
    """
    kw = dict(cfg=cfg, disc=disc, util_edges=util_edges,
              util_period=util_period, dt=dt, scrape_every=scrape_every,
              restart_blackout=restart_blackout, emits_mask=emits_mask)
    if graph is None or len(blocks) == 1:
        return [mega_window_cuda(st, est, obs, params, arrival, hazard,
                                 obs_valid, u, g, t0, forced_down=forced_down,
                                 speed=speed, row_block=rb, graph=graph, **kw)
                for st, est, obs, u, g, rb in blocks]
    r_glob = graph.has_out.shape[0]
    xch = {}
    packs = []
    for st, est, obs, u, g, rb in blocks:
        dev = st.belief.device
        if dev not in xch:
            xch[dev] = torch.empty((2, r_glob, N_MID), device=dev)
        gd = batched.GraphData(*(x.to(dev) for x in graph))
        cut = batched.block_inputs(
            params, rb, st.belief,
            (arrival, hazard, obs_valid, forced_down, speed), axis=1)
        p, arr, haz, ov, fd, sp = cut
        packs.append(_pack(st, est, obs, p, arr, haz, ov, u, g, t0,
                           forced_down=fd, speed=sp, graph=gd,
                           row0=rb[0], xch=xch[dev], **kw))
    w = blocks[0][4].shape[0]
    for i in range(w + 1):
        for pk in packs:
            _launch(pk, i, min(i + 1, w))
        if len(xch) > 1 and i < w:
            # tick i's rows (parity i & 1) to every other device, in shard
            # order, before any block reads them in launch i + 1
            for pk in packs:
                lo, n = pk["row0"], pk["args"].R
                src = pk["xch"][i & 1, lo:lo + n]
                for dev, buf in xch.items():
                    if buf is not pk["xch"]:
                        buf[i & 1, lo:lo + n].copy_(src)
    return [_unpack(pk) for pk in packs]


def _launch(packed: dict, lo: int, hi: int) -> None:
    """One launch of B3 over ticks ``[lo, hi)`` of a packed window."""
    args = packed["args"]
    args.w_lo, args.w_hi = lo, hi
    dev = packed["device"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _raise_on(library().mega_window_launch(ctypes.byref(args), stream),
                  "mega_window")
    mega_window_cuda.launches += 1


def _pack(state, est, obs_carry, params, arrival, hazard, obs_valid,
          uniforms, gumbel, t0, *, cfg, disc, util_edges, util_period, dt,
          scrape_every, restart_blackout, emits_mask, forced_down, speed,
          graph, row0: int = 0, xch: torch.Tensor | None = None) -> dict:
    """Check and pack one window's operands for :func:`_launch`; the
    tensors the launch arguments point at stay referenced in the returned
    dict.  ``row0`` is the block's first row in the graph's global rows
    and ``xch`` a shared exchange buffer (None: a new one of the block's
    own rows)."""
    dev = state.belief.device
    if dev.type != "cuda":
        raise ValueError(f"mega_window_cuda runs on CUDA tensors, got {dev}")
    cache, slots = state.cache, state.slots
    topo = cfg.topology
    r, j, s = slots.q_prev.shape
    a_n, m, nb, k = cfg.n_actions, topo.n_modalities, topo.max_bins, \
        topo.n_tiers
    p = mega_core.n_proj(topo)
    w = gumbel.shape[0]
    dwell = max(int(cfg.action_dwell_s / cfg.fast_period_s), 1)
    t0 = int(t0)
    if t0 % dwell:
        raise ValueError(f"a window starts on a dwell boundary; t0={t0} is "
                         f"not a multiple of {dwell}")
    if t0 + w > j:
        raise ValueError(f"window [{t0}, {t0 + w}) does not fit the {j} "
                         f"slots")
    m_env = batched.N_OBS_MODALITIES + (graph is not None)
    if m != m_env:
        raise ValueError(f"the kernel's env publishes {m_env} telemetry "
                         f"modalities ({'with' if graph is not None else 'no'}"
                         f" graph), the topology has {m}")
    if s > MAX_S or a_n * (p + 1) > MAX_ACC or max(k, m) > MAX_KM:
        raise ValueError(f"widths beyond the kernel's limits: S={s}, "
                         f"A·(P+1)={a_n * (p + 1)}, K={k}, M={m}")
    slot_dtype = slots.q_prev.dtype
    if slot_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"slots must be float32 or bfloat16, got "
                        f"{slot_dtype}")

    def dense(x):
        return None if x is None else x.contiguous()

    # a row block's schedule slices are strided views of the whole fleet's
    arrival, hazard, obs_valid, forced_down, speed = (
        dense(x) for x in (arrival, hazard, obs_valid, forced_down, speed))
    f32, i64 = torch.float32, torch.int64
    checks = [
        ("slots.q_prev", slots.q_prev, (r, j, s), slot_dtype),
        ("slots.q_next", slots.q_next, (r, j, s), slot_dtype),
        ("slots.obs_bins", slots.obs_bins, (r, j, m), i64),
        ("slots.obs_mask", slots.obs_mask, (r, j, m), f32),
        ("slots.action", slots.action, (r, j), i64),
        ("slots.dt_since_change", slots.dt_since_change, (r, j), f32),
        ("cache.colsum", cache.colsum, (r, a_n, s), f32),
        ("cache.proj", cache.proj, (r, p, s), f32),
        ("cache.projsum", cache.projsum, (r, p), f32),
        ("cache.qnproj", cache.qnproj, (r, j, p), f32),
        ("cache.sumqn", cache.sumqn, (r, j), f32),
        ("cache.coefact", cache.coefact, (r, j, a_n), f32),
        ("cache.logna", cache.logna, (r, m, nb, s), f32),
        ("state.t", state.t, (r,), i64),
        ("arrival", arrival, (w, r), f32),
        ("hazard", hazard, (w, r, k), f32),
        ("uniforms", uniforms, (w, 2, r, k), f32),
        ("gumbel", gumbel, (w, r, a_n), f32),
    ]
    if obs_valid is not None:
        checks.append(("obs_valid", obs_valid, (w, r, m), f32))
    if cache.b_base is not None:
        checks.append(("cache.b_base", cache.b_base, (r, a_n, s, s), f32))
    for name, x in (("forced_down", forced_down), ("speed", speed)):
        if x is not None:
            checks.append((name, x, (w, r, k), f32))
    r_glob = r
    if graph is not None:
        n_e = graph.src.shape[0]
        r_glob = graph.has_out.shape[0]
        if row0 < 0 or row0 + r > r_glob:
            raise ValueError(f"rows [{row0}, {row0 + r}) are not rows of "
                             f"the graph's {r_glob} cells")
        checks += [("graph.src", graph.src, (n_e,), i64),
                   ("graph.dst", graph.dst, (n_e,), i64),
                   ("graph.share", graph.share, (n_e,), f32),
                   ("graph.hop", graph.hop, (n_e,), f32),
                   ("graph.has_out", graph.has_out, (r_glob,), f32),
                   ("graph.in_edges", graph.in_edges,
                    (r_glob, graph.in_edges.shape[1]), i64),
                   ("graph.out_edges", graph.out_edges,
                    (r_glob, graph.out_edges.shape[1]), i64)]
        if xch is not None:
            checks.append(("xch", xch, (2, r_glob, N_MID), f32))
    for name, t, shape, dtype in checks:
        _check(name, t, shape, dev, dtype)

    # ---- packed operands (new tensors; the kernel updates them in place)
    raw_obs0, tier_util0, _, _, obs_mask0 = obs_carry
    pstack = torch.stack(
        [params.servers, params.mu, params.service_mean_s,
         params.service_p95_factor, params.queue_cap, params.unstable,
         params.restart_base, params.restart_load, params.restart_knee,
         params.restart_shock, params.restart_min_s, params.restart_max_s])
    envk = torch.stack([est.backlog, est.down_left, est.util_accum,
                        est.util_scrape, est.prev_tier_rps,
                        est.tier_requests, est.tier_success, est.n_restarts])
    envr = torch.stack([est.p95_ema, est.rps_ema, est.err_ema,
                        est.n_requests, est.n_success, est.err_timeout,
                        est.err_overflow, est.err_refused, est.err_restart],
                       dim=-1)
    obsm = torch.stack([raw_obs0, obs_mask0, est.held_obs])
    tier_util = tier_util0.to(f32).clone(memory_format=torch.contiguous_format)
    for name, t, shape in (("pstack", pstack, (12, r, k)),
                           ("envk", envk, (8, r, k)), ("envr", envr, (r, 9)),
                           ("obsm", obsm, (3, r, m)),
                           ("tier_util", tier_util, (r, k))):
        _check(name, t, shape, dev)
    belief = state.belief.clone(memory_format=torch.contiguous_format)
    prev_action = state.prev_action.clone(memory_format=torch.contiguous_format)
    scal = torch.stack([state.dt_since_change, state.error_ema], dim=-1)
    _check("belief", belief, (r, s), dev)
    _check("prev_action", prev_action, (r,), dev, i64)
    _check("scal", scal, (r, 2), dev)
    tr_act = torch.empty((w, r), dtype=i64, device=dev)
    tr_rk = torch.empty((w, 8, r, k), device=dev)
    tr_r = torch.empty((w, 4, r), device=dev)
    tr_rm = torch.empty((w, 3, r, m), device=dev)
    tr_g = None
    graph_args = {}
    if graph is not None:
        tr_g = torch.empty((w, 4, r), device=dev)
        if xch is None:
            xch = torch.empty((2, r_glob, N_MID), device=dev)
        graph_args = dict(
            g_src=graph.src.data_ptr(), g_dst=graph.dst.data_ptr(),
            g_share=graph.share.data_ptr(), g_hop=graph.hop.data_ptr(),
            g_has_out=graph.has_out.data_ptr(),
            g_in=graph.in_edges.data_ptr(), g_out=graph.out_edges.data_ptr(),
            G_E=graph.src.shape[0], G_din=graph.in_edges.shape[1],
            G_dout=graph.out_edges.shape[1], G_R=r_glob, row0=row0)
    tb = _tables(cfg, disc, tuple(util_edges), dev)

    u_c = cfg.b_prior_uniform / s
    decay = 0.5 ** (cfg.fast_period_s / cfg.error_ema_halflife_s)
    a_lat = min(1.0, 2.0 * dt / params.latency_window_s)
    a_err = min(1.0, 2.0 * dt / params.error_window_s)
    a_rps = min(1.0, 2.0 * dt / params.rps_window_s)
    args = MegaArgs(
        q_prev=slots.q_prev.data_ptr(), q_next=slots.q_next.data_ptr(),
        slot_bins=slots.obs_bins.data_ptr(),
        slot_mask=slots.obs_mask.data_ptr(),
        slot_action=slots.action.data_ptr(),
        slot_dt=slots.dt_since_change.data_ptr(),
        colsum=cache.colsum.data_ptr(), proj=cache.proj.data_ptr(),
        projsum=cache.projsum.data_ptr(), qnproj=cache.qnproj.data_ptr(),
        sumqn=cache.sumqn.data_ptr(), coefact=cache.coefact.data_ptr(),
        logna=cache.logna.data_ptr(), b_base=_ptr(cache.b_base),
        belief=belief.data_ptr(), prev_action=prev_action.data_ptr(),
        scal=scal.data_ptr(), t=state.t.data_ptr(),
        obsm=obsm.data_ptr(), tier_util=tier_util.data_ptr(),
        envk=envk.data_ptr(), envr=envr.data_ptr(),
        pstack=pstack.data_ptr(),
        arrival=arrival.data_ptr(), hazard=hazard.data_ptr(),
        obs_valid=_ptr(obs_valid), uniforms=uniforms.data_ptr(),
        gumbel=gumbel.data_ptr(),
        sf_tbl=tb["sf_tbl"].data_ptr(), logc=tb["logc"].data_ptr(),
        cost=tb["cost"].data_ptr(), ptable=tb["ptable"].data_ptr(),
        obs_edges=tb["obs_edges"].data_ptr(),
        n_edges=tb["n_edges"].data_ptr(),
        util_edges=tb["util_edges"].data_ptr(),
        tr_act=tr_act.data_ptr(), tr_rk=tr_rk.data_ptr(),
        tr_r=tr_r.data_ptr(), tr_rm=tr_rm.data_ptr(),
        forced_down=_ptr(forced_down), speed=_ptr(speed), xch=_ptr(xch),
        tr_g=_ptr(tr_g),
        R=r, J=j, S=s, A=a_n, M=m, NB=nb, K=k, W=w, P=p,
        E=tb["n_edge_cols"], n_util_edges=len(util_edges),
        n_used=min(t0, j), t0=t0, dwell=dwell, util_period=util_period,
        scrape_every=scrape_every,
        err_ix=topo.modalities.index("error"), emits_mask=int(emits_mask),
        masked_obs=int(obs_valid is not None or restart_blackout),
        restart_blackout=int(restart_blackout),
        bf16_slots=int(slot_dtype == torch.bfloat16),
        dt=dt, fast_period_s=cfg.fast_period_s, err_decay=decay,
        err_keep=1.0 - decay, error_trigger=cfg.error_trigger,
        beta=cfg.beta, u_c=u_c, d_c=cfg.b_prior_sticky,
        usd=u_c * s + cfg.b_prior_sticky, log_match=tb["log_match"],
        log_miss=tb["log_miss"], timeout_s=params.timeout_s, a_lat=a_lat,
        a_err=a_err, a_rps=a_rps, keep_lat=1.0 - a_lat, keep_err=1.0 - a_err,
        keep_rps=1.0 - a_rps, scrape_den=scrape_every * dt, **graph_args)
    return dict(args=args, device=dev, row0=row0, xch=xch, state=state,
                emits_mask=emits_mask, obs_mask0=obs_mask0, w=w,
                keep=(arrival, hazard, obs_valid, uniforms, gumbel,
                      forced_down, speed, graph, pstack),
                belief=belief, prev_action=prev_action, scal=scal,
                obsm=obsm, tier_util=tier_util, envk=envk, envr=envr,
                tr_act=tr_act, tr_rk=tr_rk, tr_r=tr_r, tr_rm=tr_rm,
                tr_g=tr_g)


def _unpack(pk: dict):
    """(state, env state, obs carry, trace) of a packed window after its
    launches, as :func:`repro_torch.core.mega.mega_window` returns them."""
    w, envk, envr, obsm = pk["w"], pk["envk"], pk["envr"], pk["obsm"]
    tr_rk, tr_r, tr_rm, tr_g = pk["tr_rk"], pk["tr_r"], pk["tr_rm"], \
        pk["tr_g"]
    scal, state = pk["scal"], pk["state"]
    new_state = state._replace(
        belief=pk["belief"], prev_action=pk["prev_action"],
        dt_since_change=scal[:, 0], error_ema=scal[:, 1],
        unstable=tr_r[-1, 2] > 0.5, t=state.t + w)
    new_est = batched.FluidState(
        backlog=envk[0], down_left=envk[1], util_accum=envk[2],
        util_scrape=envk[3], prev_tier_rps=envk[4], p95_ema=envr[:, 0],
        rps_ema=envr[:, 1], err_ema=envr[:, 2], held_obs=obsm[2],
        n_requests=envr[:, 3], n_success=envr[:, 4],
        err_timeout=envr[:, 5], err_overflow=envr[:, 6],
        err_refused=envr[:, 7], err_restart=envr[:, 8],
        tier_requests=envk[5], tier_success=envk[6], n_restarts=envk[7])
    win = batched.WindowInfo(
        raw_obs=tr_rm[:, 0], obs_mask=tr_rm[:, 1],
        tier_utilization=tr_rk[:, 1], tier_up=tr_rk[:, 2],
        tier_queue=tr_rk[:, 3], tier_latency_s=tr_rk[:, 4],
        tier_p95_s=tr_rk[:, 5], tier_completed=tr_rk[:, 6],
        success=tr_r[:, 0], failures=tr_r[:, 1], restarted=tr_rk[:, 7],
        **({} if tr_g is None else dict(
            spill_out=tr_g[:, 0], spill_in=tr_g[:, 1],
            spill_admitted=tr_g[:, 2], nbr_pressure=tr_g[:, 3])))
    trace = (pk["tr_act"], tr_rk[:, 0], tr_rm[:, 2], tr_r[:, 2] > 0.5,
             tr_r[:, 3], win)
    new_carry = (tr_rm[-1, 0], tr_rk[-1, 1], tr_rk[-1, 2], tr_rk[-1, 3],
                 tr_rm[-1, 1] if pk["emits_mask"] else pk["obs_mask0"])
    return new_state, new_est, new_carry, trace


mega_window_cuda.launches = 0
