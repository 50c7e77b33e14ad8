"""Find the knee of a served cell once, by a sweep of offered rates on the
card: the highest rate at which the queue does not grow over a window.

    python3 perfbench/tools/sweep.py --workload <cell> --seed <n> \\
        --rates 3,4,5 [--seconds 40] [--out sweep.jsonl]

One process: the weights are made once; each rate gets a fresh engine on
them, warmed up, and the cell's mix at that rate for ``--seconds``.  A line
a rate: requests due, admitted and finished in the window, the backlog
(due and not admitted) at each quarter of it, the tails and tokens/s.  The
cell's traffic file then states 0.8 x the knee as a number.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    from perfbench import harness, traffic as traffic_mod
    from perfbench import weights as weights_mod
    from perfbench.drivers import serve
    from repro_torch.serving.engine import ServingEngine
    cell = harness.resolve(harness.load_spec(ROOT), ROOT, args.workload)
    m, dev = cell.config["model"], torch.device("cuda")
    w = weights_mod.make(m, args.seed, dev)
    sink = open(args.out, "a") if args.out else None
    for rate in (float(x) for x in args.rates.split(",")):
        mix = copy.deepcopy(cell.traffic)
        mix["arrival"]["rate_per_s"] = rate
        engine = ServingEngine(serve.model_config(cell.config), params=w,
                               max_batch=mix["engine"]["max_batch"],
                               max_len=mix["engine"]["max_len"], device=dev)
        reqs = traffic_mod.requests(mix, args.seed, m["vocab_size"])
        serve.warm_up(engine, reqs, args.seed)
        t0 = time.perf_counter()
        served, steps = serve.serve_window(engine, reqs, t0, args.seconds)
        t1 = steps[-1].end if steps else t0

        def backlog(at: float) -> int:
            due = [s for s in served.values() if s.due <= at]
            return sum(1 for s in due if not s.token_times
                       or s.token_times[0] > at)

        firsts = [s.token_times[0] - s.due for s in served.values()
                  if s.token_times]
        gaps = [b - a for s in served.values()
                for a, b in zip(s.token_times, s.token_times[1:])]
        line = {"workload": cell.name, "rate_per_s": rate,
                "window_s": t1 - t0, "due": len(served),
                "admitted": len(firsts),
                "finished": sum(bool(s.engine_req.finished_at)
                                for s in served.values()),
                "backlog_by_quarter": [backlog(t0 + q * args.seconds / 4)
                                       for q in (1, 2, 3, 4)],
                "ttft_p50_ms": float(np.percentile(firsts, 50)) * 1e3,
                "ttft_p95_ms": serve.p95_ms(firsts),
                "itl_p95_ms": serve.p95_ms(gaps),
                "tokens_per_s": sum(s.tokens for s in steps) / (t1 - t0),
                "decode_steps": sum(not s.admitted for s in steps),
                "steps": len(steps)}
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
        del engine
        harness.free_device(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
