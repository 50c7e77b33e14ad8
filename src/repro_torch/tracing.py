"""Named host spans at the serving path's layer boundaries.

``span(name)`` is a profiler range while a ``torch.profiler`` profile
records, and a shared no-op context otherwise: one check of whether the
profiler is on (``torch.autograd._profiler_enabled``, a fraction of a
microsecond) is all a span costs when nothing records.  There is no
switch: the spans are on exactly while a profiler records.

A span is recorded as an operator range (``RecordFunctionFast``), on the
profiler's clock like every host event, so a reader of the timeline can
charge each idle gap of the device to the span the host was in.  Unlike a
``torch.profiler.record_function`` range it is not a user annotation, so
CUPTI puts no copy of it on the device's timeline: the device timeline of
a traced run holds the same operations with the spans as without them.
``_RecordFunctionFast`` is a private binding of torch, checked with torch
2.11 (CUDA 12.8) and 2.13 (CPU); ``tests/test_torch_tracing.py`` fails if
its import or its constructor changes.

The serving engine's spans (``engine.*``) are listed in
:mod:`repro_torch.serving.engine`; inside its ``engine.prefill`` and
``engine.decode`` the model's layers open ``attn.prefill`` and
``attn.decode`` (each attention block), ``ssm.prefill`` (each Mamba
block's mixer, ``ssm.scan`` around its SSD scan, kernel B6) and
``ssm.decode``, and ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine`` (each MoE layer).

The layers' host counters of the work a call puts on the device
(``Moe.rows``, the rows its expert products run; ``Mamba.scan_tokens``,
the bucket tokens its prefills scanned, and ``state_steps``, the lanes its
decode steps advanced) are plain integer attributes advanced through
:func:`count`.  A call recorded into a CUDA graph runs its Python once, at
the recording, and never at a replay: :func:`counts_made` collects what a
recording counted, and :func:`add_counts` takes it back or adds it again,
so a replayer keeps the counters true without naming any of them.  A
kernel wrapper's ``launches`` is not such a counter: it counts the
wrapper's calls.
"""
from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()
_made: list | None = None      # the counts made inside counts_made()


def span(name: str):
    """A context manager: the profiler range ``name`` while a profiler
    records, else nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _RecordFunctionFast(name)


def count(owner, name: str, n: int) -> None:
    """Add ``n`` to the host counter ``owner.<name>``."""
    setattr(owner, name, getattr(owner, name) + n)
    if _made is not None:
        _made.append((owner, name, n))


@contextlib.contextmanager
def counts_made():
    """Within the block, every :func:`count` is also kept in the list this
    yields, as ``(owner, name, n)``."""
    global _made
    _made = made = []
    try:
        yield made
    finally:
        _made = None


def add_counts(counts: list, times: int = 1) -> None:
    """Add each of ``counts`` (as :func:`counts_made` kept them) ``times``
    over to its counter: -1 takes them back."""
    for owner, name, n in counts:
        setattr(owner, name, getattr(owner, name) + times * n)
