"""The program's spans and counters as the benchmark reads them
(``perfbench/programtrace.py``, ``perfbench/tools/program_trace.py``):

* a timeline that also holds the program's host spans reads the same busy
  time, device time and idle share as the benchmark's timeline of the same
  events without them, and charges each idle gap to the innermost span of
  either kind; a device copy of a program span is refused;
* a CPU window of each cell reads every counter share in (0, 100], and
  ``prefill_real_share`` is what ``serve.py``'s own step records give.
"""
import types

import pytest
import torch
from perfbench_cells import small_cell

from perfbench import devtrace, programtrace
from perfbench.tools import program_trace

MS = 1_000_000
KERNELS = [(0, 10 * MS, "prefill_tc_kernel<bf16>"),
           (5 * MS, 12 * MS, "gemm"),
           (20 * MS, 25 * MS, "gemm"),
           (40 * MS, 41 * MS, "decode_split_kernel")]
BENCH = [(0, 50 * MS, "bench.step"),
         (13 * MS, 19 * MS, "bench.admit"),
         (30 * MS, 39 * MS, "bench.wave")]
PROGRAM = [(14 * MS, 18 * MS, "engine.admit"),
           (15 * MS, 17 * MS, "moe.dispatch"),
           (29 * MS, 45 * MS, "engine.decode"),
           (31 * MS, 34 * MS, "attn.decode")]
# the annotations' copies on the device: from the first to the last
# operation a span launched, over the idle gaps between (the driver's
# ``bench.*`` user annotations have them; the program's operator ranges
# none)
COPIES = {"bench.step": (0, 41 * MS)}


class _Event:
    def __init__(self, start, end, name, on_device):
        self._s, self._e, self._n = start, end, name
        self._d = (torch.autograd.DeviceType.CUDA if on_device
                   else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


def _prof(with_program: bool, copies: dict = COPIES):
    """A stopped profiler's stand-in: kernels and the ``bench.*`` spans, and
    optionally the program's spans, with the device copies ``copies``."""
    spans = BENCH + (PROGRAM if with_program else [])
    events = [_Event(*k, True) for k in KERNELS]
    events += [_Event(*s, False) for s in spans]
    events += [_Event(*copies[n], n, True) for _, _, n in spans
               if n in copies]
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        stop=lambda: None,
        profiler=types.SimpleNamespace(kineto_results=results))


def test_program_spans_leave_the_device_readings_as_they_were():
    plain = devtrace.stop(_prof(False))
    tl = programtrace.stop(_prof(True))
    assert tl.device == plain.device
    assert tl.busy_s == plain.busy_s
    for names in (("prefill_tc_kernel",), ("decode_split_kernel",),
                  ("gemm",)):
        assert tl.device_s(*names) == plain.device_s(*names)
    assert tl.breakdown()["device_ops"] == plain.breakdown()["device_ops"]
    with pytest.raises(ValueError, match="engine.decode"):
        programtrace.stop(_prof(True, dict(
            COPIES, **{"engine.decode": (20 * MS, 41 * MS)})))


def test_idle_gaps_go_to_the_innermost_span_of_either_kind():
    tl = programtrace.stop(_prof(True))
    # gap 12-20 (mid 16: in moe.dispatch inside engine.admit inside
    # bench.admit), gap 25-40 (mid 32.5: attn.decode inside bench.wave)
    gaps = tl.idle_by_host()
    assert gaps == pytest.approx({"moe.dispatch": 0.008,
                                  "attn.decode": 0.015}, abs=1e-12)
    # with no program span open, a gap keeps its ``bench.*`` label
    plain = devtrace.stop(_prof(False)).idle_by_host()
    assert plain == pytest.approx({"bench.admit": 0.008,
                                   "bench.wave": 0.015}, abs=1e-12)
    assert sum(gaps.values()) == pytest.approx(sum(plain.values()))


@pytest.mark.parametrize("workload", ["mixtral-longdoc", "mixtral-code"])
def test_a_cpu_window_reads_every_share(workload):
    cell = small_cell(workload)
    win = program_trace.window(cell, 2**31 + 11, 3.0, torch.device("cpu"))
    line = program_trace.reading(cell, win)
    q = line["program"]
    for name in ("lane_use", "b5_live_keys", "prefill_real_share",
                 "moe_row_use"):
        assert 0 < q[name] <= 100, (name, q[name])
    assert q["wave_launch_ms"] > 0 and q["wave_sync_ms"] > 0
    assert q["queue_wait_p95_ms"] >= 0
    admitted = [n for s in win.steps for n in s.admitted]
    assert admitted and win.counts["prompt_tokens"] == sum(admitted)
    assert q["prefill_real_share"] == pytest.approx(
        100 * sum(admitted) / sum(win.engine._bucket(n) for n in admitted))
    assert win.counts["waves"] == sum(1 for s in win.steps if s.positions)
    # each wave runs every lane; the live ones are the step records'
    lanes = cell.traffic["engine"]["max_batch"]
    assert win.counts["lanes"] == lanes * win.counts["waves"]
    assert win.counts["live_lanes"] == sum(len(s.positions)
                                           for s in win.steps)
