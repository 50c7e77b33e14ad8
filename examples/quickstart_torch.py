"""Quickstart on the PyTorch/CUDA port: AIF-Router learning to route on
the simulated edge testbed (the port's counterpart of ``quickstart.py``).

Runs the paper's router for 10 simulated minutes against the 3-tier
continuum and prints what it learned, line for line as the reference
script does.  The event simulator and the uniform baseline are host numpy;
the router's tick runs on ``--device`` (plain PyTorch, no kernel, as in the
reference).

    PYTHONPATH=src python examples/quickstart_torch.py [--quick]
                                                       [--device cpu]

``--quick`` runs a 2-minute horizon (CI smoke).  ``--device`` defaults to
``cuda`` and raises without a card.
"""
import argparse
import collections

import numpy as np

from repro_torch.baselines import UniformRouter
from repro_torch.core import default_topology, policies
from repro_torch.device import resolve_device
from repro_torch.envsim import AifRouter, SimConfig, run_experiment


def main(argv=None) -> list[str]:
    """Run the example; returns the lines it printed."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="short horizon for CI smoke runs")
    ap.add_argument("--device", default="cuda",
                    help="where the router's tensors live (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    lines = []

    def say(line=""):
        print(line, flush=True)
        lines.append(line)

    duration = 120 if args.quick else 600
    cfg = SimConfig()
    say(f"testbed: capacity {cfg.capacity_rps:.0f} RPS "
        f"(weights-if-you-knew {np.round(cfg.capacity_weights(), 2)}), "
        f"offered {cfg.rps:.0f} RPS bursty")

    say("\n-- uniform baseline (the paper's comparison) --")
    uni = run_experiment(UniformRouter(), cfg, duration, seed=0)
    say(f"success {100*uni.success_rate:.1f}%  P50 {uni.p50_ms:.0f} ms  "
        f"P95 {uni.p95_ms:.0f} ms")

    say("\n-- AIF-Router (zero-shot, learns online) --")
    router = AifRouter(seed=0, device=device)
    res = run_experiment(router, cfg, duration, seed=0)
    say(f"success {100*res.success_rate:.1f}%  P50 {res.p50_ms:.0f} ms  "
        f"P95 {res.p95_ms:.0f} ms")

    acts = res.action_trace
    tbl = policies.generate_policy_table(default_topology())
    seg_len = max(duration // 3, 1)
    for q in range(3):
        seg = acts[q * seg_len:(q + 1) * seg_len]
        w = tbl[seg].mean(0)
        top = collections.Counter(seg.tolist()).most_common(3)
        say(f"  t={q*seg_len:4d}s..{(q+1)*seg_len}s  mean weights L/M/H "
            f"{np.round(w, 2)}  top policies {top}")
    say(f"  tier share of successes L/M/H: "
        f"{np.round(res.tier_share_of_success(), 3)}")
    say(f"  pod restarts L/M/H: {res.n_restarts}")
    say("\nthe router shifts traffic toward the heavy tier without being "
        "told tier capacities — the paper's core claim.")
    return lines


if __name__ == "__main__":
    main()
