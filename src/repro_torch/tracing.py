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

The names (``engine.*``, ``attn.*``, ``ssm.*``, ``moe.*``) and their nesting are
listed in :mod:`repro_torch.serving.engine`.
"""
from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the profiler range ``name`` while a profiler
    records, else nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _RecordFunctionFast(name)
