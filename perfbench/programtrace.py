"""The program's own view of a served window: the port's counters and its
host spans, and the per-layer quantities they give.

The port counts in plain host integers (``ServingEngine.counters()``, each
``Moe``'s ``rows``) and marks its layers with spans named
``engine.*``, ``attn.*`` and ``moe.*`` while a profiler records
(:mod:`repro_torch.tracing`).  :func:`counters` snapshots the counters, and
the window's counts are the difference of the snapshots taken when it
opens and when it closes.  :func:`stop` is :func:`perfbench.devtrace.stop`
with the program's host spans added to ``serve.py``'s ``bench.*`` spans, so
each idle gap is charged to the innermost span of either kind; its device
operations are devtrace's, and it refuses a timeline that holds a device
copy of a program span (the port's spans are operator ranges, of which
CUPTI makes none).

:func:`stop` and ``tools/program_trace.py::window`` stand in for what
``perfbench/devtrace.py`` and ``perfbench/drivers/serve.py`` do not do yet
(take the program's spans and the counter snapshots); they go once those
files do, and :func:`counters` and :func:`quantities` remain for the
metrics' readers.

The quantities (None where the window has nothing to read):

* ``wave_launch_ms``: median ``engine.decode`` span, the host enqueueing a
  decode wave; ``wave_sync_ms``: median ``engine.sample`` span, the host
  waiting for it;
* ``lane_use``: 100 x live lanes / lanes the waves computed;
* ``b5_live_keys``: 100 x live lanes' keys / keys kernel B5 was asked to
  read;
* ``prefill_real_share``: 100 x real prompt tokens / bucket tokens
  prefilled;
* ``moe_row_use``: 100 x top_k x MoE layers x (real prompt tokens + live
  lanes) / capacity rows the expert GEMMs ran;
* ``queue_wait_p95_ms``: p95 of the admissions' ``admitted_at -
  submitted_at``.
"""
from __future__ import annotations

import statistics

import numpy as np

from perfbench import devtrace

PREFIXES = ("engine.", "attn.", "moe.")


def moes(engine) -> list:
    """The engine's MoE layers."""
    from repro_torch.models.moe import Moe
    return [m for m in engine.model.modules() if isinstance(m, Moe)]


def counters(engine) -> dict:
    """The engine's counters and the sum of its MoE layers' ``rows``."""
    return dict(engine.counters(),
                moe_rows=sum(m.rows for m in moes(engine)))


def difference(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def host_spans(prof) -> list:
    """The program's spans on the host, (start_ns, end_ns, name), from a
    stopped profiler."""
    from torch.autograd import DeviceType
    return [(e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(PREFIXES)
            and e.device_type() != DeviceType.CUDA]


def stop(prof) -> devtrace.Timeline:
    """The window's :class:`perfbench.devtrace.Timeline` with the program's
    host spans among its spans.  Raises ``ValueError`` if a device event is
    named as a program span: devtrace would count it as device work."""
    tl = devtrace.stop(prof)
    copies = sorted({d[2] for d in tl.device if d[2].startswith(PREFIXES)})
    if copies:
        raise ValueError(f"program spans on the device timeline: {copies}")
    # outer before inner where two spans open at the same instant
    spans = sorted(tl.spans + host_spans(prof), key=lambda s: (s[0], -s[1]))
    return devtrace.Timeline(device=tl.device, spans=spans)


def _share(num, den) -> float | None:
    return 100.0 * num / den if den else None


def span_median_ms(spans: list, name: str) -> float | None:
    d = [e - s for s, e, n in spans if n == name]
    return 1e-6 * statistics.median(d) if d else None


def quantities(c: dict, spans: list, waits: list, top_k: int,
               layers: int) -> dict:
    """The per-layer quantities of a window's counts ``c``, its program
    spans and its admissions' queue waits (seconds)."""
    return {
        "wave_launch_ms": span_median_ms(spans, "engine.decode"),
        "wave_sync_ms": span_median_ms(spans, "engine.sample"),
        "lane_use": _share(c["live_lanes"], c["lanes"]),
        "b5_live_keys": _share(c["live_keys"], c["b5_keys"]),
        "prefill_real_share": _share(c["prompt_tokens"], c["bucket_tokens"]),
        "moe_row_use": _share(top_k * layers * (c["prompt_tokens"]
                                                + c["live_lanes"]),
                              c["moe_rows"]),
        "queue_wait_p95_ms": (float(np.percentile(waits, 95)) * 1e3
                              if waits else None),
    }
