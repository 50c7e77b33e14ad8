"""Small cells of the benchmark for the CPU tests."""
import json
import time

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_MODEL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=96, vocab_size=512, n_experts=4)


def small_cell(workload: str, **sizes):
    """A cell of BENCHMARK.json cut to a size the CPU runs in seconds."""
    from perfbench import harness
    cell = harness.resolve(harness.load_spec(ROOT), ROOT, workload)
    cell.config["model"].update(TINY_MODEL, **sizes)
    cell.traffic["prompt"] = dict(cell.traffic["prompt"], lo=20, hi=40)
    cell.traffic["output"] = dict(cell.traffic["output"], lo=4, hi=8)
    cell.traffic["engine"] = {"max_batch": 4, "max_len": 64}
    if cell.traffic["arrival"]["process"] == "poisson":
        cell.traffic["arrival"] = {"process": "poisson", "rate_per_s": 400.0}
    return cell


def run_small(cell, seed: int = 2**31 + 7, seconds: float = 1.5,
              driver=None, **attrs):
    """Drive a whole run of ``cell`` on the CPU (the harness's look for a
    card skipped) and return its outcome."""
    from perfbench import harness
    drv = driver or harness.driver_for(ROOT, cell)
    for k, v in attrs.items():
        setattr(drv, k, v)
    ctx = harness.Context(cell, seed, seconds, False, time.perf_counter(),
                          device="cpu")
    return drv.run(ctx)


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
