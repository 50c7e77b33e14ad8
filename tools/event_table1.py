"""The paper's Table-1 protocol on the event simulator with the port's
routers: ``benchmarks/table1_routing.py --engine event`` for
``repro_torch``, with the AIF router's single-agent tick on ``--device``
(the card by default).

    python3 tools/event_table1.py                    # 3 x 600 s, 7 strategies
    python3 tools/event_table1.py --full --strategies aif,uniform
    python3 tools/event_table1.py --device cpu --duration 120 --runs 2

Each strategy runs ``--runs`` independent runs of ``--duration`` simulated
seconds (``--full``: the paper's 3 x 45 minutes) through
``repro_torch.envsim.evaluate_strategy``, one control window a second at
50 RPS.  Prints the card's name and power limit (``nvidia-smi``) on a CUDA
device, the table, the Δ(AIF−Base) line beside the paper's, and each
strategy's wall and host ms per control window; ``--out`` writes the
numbers as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: The event engine's strategies, in ``benchmarks/table1_routing.py``'s order.
STRATEGIES = ("aif", "uniform", "capacity", "round_robin", "least_loaded",
              "thompson", "ucb")
PAPER_DELTA = "paper:        P50 -34.7%  success -11.5pp  heavy-share +8pp"


def make_routers(device: str) -> dict:
    """Strategy name -> ``make_router(seed)``, a fresh router per run."""
    from repro_torch.baselines import (CapacityRouter, LeastLoadedRouter,
                                       RoundRobinRouter, ThompsonRouter,
                                       UcbRouter, UniformRouter)
    from repro_torch.envsim import AifRouter
    return {
        "aif": lambda seed: AifRouter(seed=seed, device=device),
        "uniform": lambda seed: UniformRouter(),
        "capacity": lambda seed: CapacityRouter(),
        "round_robin": lambda seed: RoundRobinRouter(),
        "least_loaded": lambda seed: LeastLoadedRouter(),
        "thompson": lambda seed: ThompsonRouter(seed=seed),
        "ucb": lambda seed: UcbRouter(),
    }


def run_event(duration_s: float, n_runs: int,
              strategies: tuple = STRATEGIES, device: str = "cuda",
              base_seed: int = 0) -> tuple[list, dict]:
    """Run the protocol: (one ``StrategySummary`` per strategy, wall
    seconds per strategy)."""
    from repro_torch.envsim import SimConfig, evaluate_strategy
    makers = make_routers(device)
    unknown = set(strategies) - set(makers)
    if unknown:
        raise SystemExit(f"unknown strategies {sorted(unknown)}; "
                         f"available: {sorted(makers)}")
    summaries, walls = [], {}
    for name in strategies:
        t0 = time.perf_counter()
        summaries.append(evaluate_strategy(makers[name], name, SimConfig(),
                                           duration_s=duration_s,
                                           n_runs=n_runs,
                                           base_seed=base_seed))
        walls[name] = time.perf_counter() - t0
    return summaries, walls


def delta_line(summaries) -> str | None:
    """Δ(AIF−Base) in P50, success and the heavy tier's share of successes,
    as ``benchmarks/table1_routing.py`` prints it (None without both)."""
    by = {s.name: s for s in summaries}
    aif, uni = by.get("aif"), by.get("uniform")
    if aif is None or uni is None:
        return None
    dp50 = 100 * (aif.p50_ms_mean / max(uni.p50_ms_mean, 1e-9) - 1)
    dsucc = aif.success_pct_mean - uni.success_pct_mean
    dheavy = 100 * (aif.tier_share_mean[-1] - uni.tier_share_mean[-1])
    return (f"Δ(AIF−Base): P50 {dp50:+.1f}%  success {dsucc:+.1f}pp  "
            f"heavy-share {dheavy:+.1f}pp")


def summary_json(s, wall_s: float) -> dict:
    return {"success_pct": [s.success_pct_mean, s.success_pct_std],
            "p50_ms": [s.p50_ms_mean, s.p50_ms_std],
            "p95_ms": [s.p95_ms_mean, s.p95_ms_std],
            "tier_share_of_success": s.tier_share_mean.tolist(),
            "routed_share": s.routed_share_mean.tolist(),
            "restarts": s.restarts_mean.tolist(),
            "n_runs": len(s.runs),
            "windows_per_run": int(s.runs[0].weights_trace.shape[0]),
            "wall_s": wall_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--strategies", default=",".join(STRATEGIES))
    ap.add_argument("--duration", type=float, default=600.0,
                    help="simulated seconds per run")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--full", action="store_true",
                    help="the paper's protocol: 3 x 2700 s")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    a = ap.parse_args(argv)
    duration, runs = (2700.0, 3) if a.full else (a.duration, a.runs)
    card = None
    if a.device.startswith("cuda"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
    from repro_torch.envsim import table1
    summaries, walls = run_event(duration, runs,
                                 tuple(a.strategies.split(",")), a.device,
                                 a.seed)
    print(table1(summaries))
    delta = delta_line(summaries)
    if delta is not None:
        print(f"\n{delta}\n{PAPER_DELTA}")
    windows = runs * int(round(duration))
    for s in summaries:
        print(f"{s.name:<14} wall {walls[s.name]:.3f} s  "
              f"{1e3 * walls[s.name] / windows:.4f} ms per window")
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"card": card, "device": a.device,
                       "duration_s": duration, "n_runs": runs,
                       "seed": a.seed, "delta": delta,
                       "table": table1(summaries),
                       "strategies": {s.name: summary_json(s, walls[s.name])
                                      for s in summaries}}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
