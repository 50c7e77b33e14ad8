"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout; its configuration, traffic mix, driver, reference and
per-layer metric readers are files under ``perfbench/`` found by name
(see :mod:`perfbench.harness`).  The last line of standard output is the
result as one JSON object; the numbers compared for ``correct`` are also
the last lines of standard error.
"""
import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from perfbench import harness
    sys.exit(harness.main(sys.argv[1:], ROOT, T_PROCESS))
