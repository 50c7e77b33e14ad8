"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA.  Phases, each printing one JSON line, any
failure raising (exit code != 0):

1. device — the card, as ``nvidia-smi`` names it, and its power limit;
2. build — compiles every CUDA source of the port with ``nvcc`` (one
   process per library, started together);
3. kernel vs plain — each kernel at full width (paper-3tier, R=1024) on
   seeded inputs shaped like a real model cache, against its plain PyTorch
   version on the same inputs on the card;
4. small slice — ``Experiment(R=4, T=30)`` on the card and on the CPU with
   the same draws: actions equal, metrics within 1e-4;
5. the slice — ``repro_torch.api.run(Experiment(router="aif",
   scenario="paper-burst", n_cells=1024, n_windows=300))`` on the card, with
   every kernel's launch count read around it;
   then the per-call times of the held-tick posterior and the slow step on
   its final state;
6. times — each kernel's ms per launch (CUDA events, warmed up, median)
   beside its bound and its plain version's ms.

Then the kernels line and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM rate and dense fp32
# rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
R_FULL, T_FULL = 1024, 300
DEVICE = "cuda"
G_TOL, Q_TOL = 1e-4, 1e-5     # kernel vs plain version, max abs error


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median ms of one call, timed with CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=line, torch_name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return name


def phase_build() -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.efe import efe
    libraries = {"efe_fleet": efe.SOURCES}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        futs = {name: pool.submit(build.build, name, srcs)
                for name, srcs in libraries.items()}
        paths = {name: f.result() for name, f in futs.items()}
    secs = time.perf_counter() - t0
    efe.library()               # load once, so later timings exclude it
    ptxas = {name: [ln.strip() for ln in
                    (p.parent / "ptxas.log").read_text().splitlines()
                    if "Used" in ln or "spill" in ln]
             for name, p in paths.items()}
    emit("build", seconds=secs, libraries=sorted(libraries), ptxas=ptxas)


def full_width_operands(masked: bool, seed: int = 0):
    """Inputs shaped like a real model cache at the paper's widths:
    column-stochastic nb, normalized na, finite log-preferences."""
    from repro_torch.core import generative, policies, spaces
    from repro_torch.core.topology import default_topology
    topo = default_topology()
    cfg = generative.AifConfig(topology=topo)
    r, s, a = R_FULL, topo.n_states, cfg.n_actions
    m, nbin = topo.n_modalities, topo.max_bins
    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    nb = torch.from_numpy(rng.random((r, a, s, s), dtype=np.float32)
                          ).to(dev).add_(0.01)
    nb /= nb.sum(dim=-2, keepdim=True)
    mask_bins = spaces.bins_mask(topo, dev)
    na = torch.from_numpy(rng.random((r, m, nbin, s), dtype=np.float32)
                          ).to(dev).add_(0.01) * mask_bins[:, :, None]
    na /= na.sum(dim=-2, keepdim=True)
    c_log = torch.from_numpy(rng.normal(0.0, 2.0, (r, m, nbin))
                             .astype(np.float32)).to(dev)
    logc = generative.masked_log_c(c_log, topo)
    q = torch.from_numpy(rng.dirichlet(np.ones(s), r).astype(np.float32)
                         ).to(dev)
    prev = torch.from_numpy(rng.integers(0, a, r)).to(dev)
    obs = torch.from_numpy(rng.integers(0, 2, (r, m))).to(dev)
    mask = None
    if masked:
        mask = torch.from_numpy(rng.integers(0, 2, (r, m)).astype(np.float32)
                                ).to(dev)
    from repro_torch.core import belief
    loglik = belief.log_likelihood_from_normalized(na, obs, mask)
    amb_m = generative.modality_ambiguity_from_normalized(na, topo)
    amb = (amb_m.sum(dim=-2) if mask is None
           else generative.masked_ambiguity(amb_m, mask))
    cost = cfg.cost_weight * policies.policy_concentration_cost(topo, dev)
    return dict(nb=nb, prev=prev, q=q, loglik=loglik, na=na, logc=logc,
                amb=amb, cost=cost, mask=mask)


def kernel_calls(d):
    """(kernel, plain version) closures for B1 and B2 on operands ``d``."""
    from repro_torch.kernels.efe import efe, ref
    b1 = (lambda: efe.belief_efe_fleet(d["nb"], d["prev"], d["q"],
                                       d["loglik"], d["na"], d["logc"],
                                       d["amb"], d["cost"], d["mask"]),
          lambda: ref.belief_efe_fleet_ref(
              ref.gather_prev_b(d["nb"], d["prev"]), d["q"], d["loglik"],
              d["nb"], d["na"], d["logc"], d["amb"], d["cost"], d["mask"]))
    b2 = (lambda: (efe.efe_fleet(d["nb"], d["q"], d["na"], d["logc"],
                                 d["amb"], d["cost"], d["mask"]),),
          lambda: (ref.efe_fleet_ref(d["nb"], d["q"], d["na"], d["logc"],
                                     d["amb"], d["cost"], d["mask"]),))
    return {"belief_efe_fleet": b1, "efe_fleet": b2}


def phase_kernel_vs_plain() -> dict:
    errs = {}
    for masked in (False, True):
        d = full_width_operands(masked)
        for name, (kern, plain) in kernel_calls(d).items():
            out_k, out_p = kern(), plain()
            torch.cuda.synchronize()
            g_err = (out_k[0] - out_p[0]).abs().max().item()
            q_err = ((out_k[1] - out_p[1]).abs().max().item()
                     if len(out_k) > 1 else 0.0)
            finite = bool(torch.isfinite(out_k[0]).all())
            emit("kernel_vs_plain", kernel=name, masked=masked, r=R_FULL,
                 g_max_abs_err=g_err, q_max_abs_err=q_err,
                 g_tol=G_TOL, q_tol=Q_TOL)
            if not (finite and g_err <= G_TOL and q_err <= Q_TOL):
                raise AssertionError(
                    f"{name} (masked={masked}) disagrees with its plain "
                    f"version: G err {g_err}, q err {q_err}")
            errs[name] = max(errs.get(name, 0.0), g_err, q_err)
        del d
    torch.cuda.empty_cache()
    return errs


class MirroredNoise:
    """Draws from a CPU generator, handed out on ``device``: two runs on
    two devices see the same random numbers."""

    def __init__(self, seed: int, device: str):
        from repro_torch.noise import GeneratorNoise
        self.src = GeneratorNoise(seed, "cpu")
        self.device = torch.device(device)

    def gumbel(self, t, shape):
        return self.src.gumbel(t, shape).to(self.device)

    def replay_indices(self, t, size, batch):
        return self.src.replay_indices(t, size.cpu(), batch).to(self.device)

    def env_uniforms(self, t, shape):
        return tuple(u.to(self.device) for u in self.src.env_uniforms(t,
                                                                     shape))


def phase_small_slice() -> None:
    from repro_torch import api
    runs = {}
    for dev in (DEVICE, "cpu"):
        e = api.Experiment(router="aif", scenario="paper-burst", n_cells=4,
                           n_windows=30, seed=1, device=dev)
        runs[dev] = api.run(e, noise=MirroredNoise(1, dev))
    gpu, cpu = runs[DEVICE], runs["cpu"]
    same_actions = bool(torch.equal(gpu.trace.actions.cpu(),
                                    cpu.trace.actions))
    rel = {k: abs(getattr(gpu, k) - getattr(cpu, k))
           / max(abs(getattr(cpu, k)), 1e-9)
           for k in ("success_pct", "p50_ms", "p95_ms")}
    belief_err = (gpu.final_carry.belief.cpu()
                  - cpu.final_carry.belief).abs().max().item()
    emit("small_slice", n_cells=4, n_windows=30, actions_equal=same_actions,
         rel_err=rel, belief_max_abs_err=belief_err)
    if not same_actions or max(rel.values()) > 1e-4 or belief_err > 1e-5:
        raise AssertionError("the CUDA path disagrees with the CPU path on "
                             "the small slice")


def phase_slice() -> dict:
    from repro_torch import api
    from repro_torch.kernels.efe import efe
    kernels = {"belief_efe_fleet": efe.belief_efe_fleet,
               "efe_fleet": efe.efe_fleet}
    e = api.Experiment(router="aif", scenario="paper-burst", n_cells=R_FULL,
                       n_windows=T_FULL, seed=0, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    res = api.run(e)
    launches = {name: k.launches for name, k in kernels.items()}
    selecting = math.ceil(T_FULL / api.AifRouter().dwell)
    metrics = dict(success_pct=res.success_pct, p50_ms=res.p50_ms,
                   p95_ms=res.p95_ms)
    q = res.final_carry.belief
    belief_ok = bool(torch.isfinite(q).all()) and float(
        (q.sum(-1) - 1).abs().max()) < 1e-4
    emit("slice", scenario=e.scenario, n_cells=R_FULL, n_windows=T_FULL,
         wall_s=res.wall_s, launches=launches, selecting_ticks=selecting,
         tier_share=[float(x) for x in res.tier_share],
         obs_frac=res.obs_frac, watchdog_events=res.watchdog_events,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         actions_shape=list(res.trace.actions.shape), beliefs_ok=belief_ok,
         **metrics)
    if launches["belief_efe_fleet"] != selecting:
        raise AssertionError(f"belief_efe_fleet launched "
                             f"{launches['belief_efe_fleet']} times, "
                             f"expected {selecting}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite slice metrics {metrics}")
    if tuple(res.trace.actions.shape) != (T_FULL, R_FULL) or not belief_ok:
        raise AssertionError("slice outputs have the wrong shape or "
                             "unnormalized beliefs")
    layer_times(res.final_carry)
    del res
    torch.cuda.empty_cache()
    return launches


def layer_times(carry) -> None:
    """Per-call times of the plain PyTorch layers around the kernel at the
    slice's shapes, on the slice's final state: the held-tick posterior
    (4 of every 5 ticks) and the slow step (1 of every 10 ticks)."""
    from repro_torch import api
    from repro_torch.core import fleet
    from repro_torch.kernels.efe import ops
    from repro_torch.noise import GeneratorNoise
    cfg = api.AifRouter().cfg
    loglik = torch.zeros_like(carry.belief)
    held_ms = time_ms(lambda: ops.fleet_belief_posterior(
        carry.cache.nb, carry.belief, carry.prev_action, loglik))
    idx = GeneratorNoise(0, carry.belief.device).replay_indices(
        0, carry.replay.size, cfg.replay_batch)
    slow_ms = time_ms(lambda: fleet.fleet_slow_step(carry, idx, cfg),
                      warmup=1, iters=5)
    emit("layers", n_cells=carry.belief.shape[0],
         held_posterior_ms=held_ms, slow_step_ms=slow_ms)


def bound(d, name: str) -> tuple[float, str]:
    """Least time for the work: bytes of inputs read once and outputs
    written once over the HBM rate, against fp32 operations over the fp32
    rate; the larger one bounds it."""
    r, a, s, _ = d["nb"].shape
    m, nbin = d["na"].shape[1], d["na"].shape[2]
    ins = ["nb", "q", "na", "logc", "amb", "cost", "mask"]
    outs = r * a * 4
    flops = r * a * (2 * s * s + 3 * s + 2 * m * nbin * s + 4 * m * nbin)
    if name == "belief_efe_fleet":
        ins += ["prev", "loglik"]
        outs += r * s * 4
        flops += r * (2 * s * s + 8 * s)
    nbytes = sum(d[k].numel() * d[k].element_size()
                 for k in ins if d[k] is not None) + outs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_times(errs: dict, launches: dict) -> list:
    d = full_width_operands(masked=False)
    rows = []
    replaces = {"belief_efe_fleet": "src/repro/kernels/efe/efe.py:250",
                "efe_fleet": "src/repro/kernels/efe/efe.py:118"}
    for name, (kern, plain) in kernel_calls(d).items():
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        ms2 = time_ms(kern)
        b_ms, b_by = bound(d, name)
        emit("times", kernel=name, r=R_FULL, ms=ms, ms_repeat=ms2,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             achieved_tb_s=None if b_by != "bytes" else
             b_ms / ms * HBM_BYTES_PER_S / 1e12)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/efe_fleet.cu",
                     "replaces": replaces[name],
                     "launches": launches[name],
                     "max_abs_err": errs[name], "max_err": errs[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    phase_build()
    errs = phase_kernel_vs_plain()
    phase_small_slice()
    launches = phase_slice()
    rows = phase_times(errs, launches)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
