"""The window's device timeline from ``torch.profiler`` (CUPTI), reduced to
what the per-layer readers and the result line need: the seconds in which
an operation ran on the device, device seconds by kernel name, and the
idle gaps labelled by what the host was doing.

The host's side comes from the benchmark's own spans: ``record_function``
ranges named ``bench.<part>`` that the drivers open around their calls
into the program's layers.  An idle gap is charged to the innermost such
span open at its midpoint (``host.other`` where none is).

The reduction of device time by kernel name follows ``device_ms`` of
``chip_smoke.py`` (profiler device time summed by kernel name); its idle
share is taken here from the traced window's timeline instead of one
call's wall.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

SPAN_PREFIX = "bench."


def start():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop(prof) -> "Timeline":
    prof.stop()
    from torch.autograd import DeviceType
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            # the host's span (its copy on the device's timeline, which
            # CUPTI records as an annotation, is no operation)
            if e.device_type() != DeviceType.CUDA:
                spans.append((e.start_ns(), e.end_ns(), name))
        elif e.device_type() == DeviceType.CUDA:
            device.append((e.start_ns(), e.end_ns(), name))
    if not device:
        raise RuntimeError("the profiler recorded no device operation in the "
                           "traced window (CUPTI tracing unavailable?)")
    return Timeline(device=sorted(device), spans=sorted(spans))


@dataclasses.dataclass
class Timeline:
    """Device operations and host spans as (start_ns, end_ns, name)."""
    device: list
    spans: list

    def busy_intervals(self) -> list:
        merged = []
        for s, e, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def device_s(self, *substrings: str) -> float:
        """Device seconds of the operations whose name holds any of
        ``substrings``."""
        return 1e-9 * sum(e - s for s, e, n in self.device
                          if any(k in n for k in substrings))

    def idle_by_host(self) -> dict:
        """Idle seconds between device operations, by the innermost host
        span open at each gap's midpoint."""
        busy = self.busy_intervals()
        out = defaultdict(float)
        # one sweep: the spans of one host thread nest, so the open ones
        # form a stack whose top is the innermost
        stack, i = [], 0
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = (a + b) // 2
            while i < len(self.spans) and self.spans[i][0] <= mid:
                while stack and stack[-1][1] < self.spans[i][0]:
                    stack.pop()
                stack.append(self.spans[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            out[stack[-1][2] if stack else "host.other"] += (b - a) * 1e-9
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        ops = defaultdict(float)
        for s, e, n in self.device:
            ops[n] += (e - s) * 1e-9
        ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in gaps[:top]]}
