"""The benchmark's harness: resolve a cell by name, run its driver, read
its metrics, check the run and print the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by name, so a later change adds a cell by adding
files and entries and edits none:

* ``BENCHMARK.json`` (root of the checkout): the cells, the configurations'
  files and the metrics with the cells that report them;
* ``perfbench/configs/<config>.json``: the configuration as it is run,
  with ``driver`` (a module of ``perfbench/drivers/``) and ``reference``
  (a module of ``perfbench/reference/``);
* ``perfbench/traffic/<traffic>.json``: the traffic mix, read by
  :mod:`perfbench.traffic`;
* ``perfbench/metrics/<metric>.py``: the reader of one per-layer metric, a
  function ``read(rec)`` of the run's :class:`Record` returning a number
  or None (nothing to read: the metric is left out of the line).

A driver's ``run(ctx)`` builds the system under test, warms up every shape
the cell's traffic uses, measures for ``--seconds`` inside
:meth:`Context.window` and returns an :class:`Outcome`, its comparison
with the reference made after the window closed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

#: Top-level module names the measured process must not hold: JAX and the
#: JAX package the port was made from (compared whole: ``repro_torch``
#: is the port).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Check:
    """One number compared for ``correct``: it passes at or under
    ``limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: its end-to-end values by metric name, the
    work attempted and failed, and the comparison with the reference."""
    values: dict
    attempted: int
    failed: int
    checks: list
    notes: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Record:
    """What the per-layer readers see: the driver's counters and work
    lists, and with ``--trace 1`` the window's device timeline
    (:class:`perfbench.devtrace.Timeline`)."""
    cell: str
    counters: dict = dataclasses.field(default_factory=dict)
    window_s: float = 0.0
    timeline: object = None


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _for_cell(entries: list, cell: str) -> list:
    return [m for m in entries if "workloads" not in m
            or cell in m["workloads"]]


def resolve(spec: dict, root: Path, workload: str) -> Cell:
    """The cell named ``workload`` with its configuration and traffic
    files read."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"know {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=workload, config_name=w["config"],
                chips=int(w["chips"]),
                config=config, traffic=traffic,
                end_to_end=_for_cell(spec["end_to_end"], workload),
                per_layer=_for_cell(spec["per_layer"], workload))


def load_module(path: Path):
    """A module of the benchmark from its file (names may hold dots)."""
    name = "perfbench_file_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver_for(root: Path, cell: Cell):
    return load_module(root / "perfbench" / "drivers"
                       / f"{cell.config['driver']}.py")


def reader_for(root: Path, metric: str):
    return load_module(root / "perfbench" / "metrics" / f"{metric}.py")


class Context:
    """One run: the cell, its seed and window length, the record the
    per-layer readers read, and the measured window."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 t_process: float, device: str = "cuda"):
        import torch
        self.device = torch.device(device)
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.t_process = t_process
        self.record = Record(cell=cell.name)
        self.setup_s = None
        self.memory_peak_bytes = None
        self._t0 = None
        self._prof = None

    @contextlib.contextmanager
    def window(self):
        """The measured window.  Set-up ends where it opens (the device
        idle); the driver closes it with :meth:`close` at the end of its
        last piece of work, and the profiler (``--trace 1``) covers just
        that span."""
        self.sync()
        if self.trace:
            from perfbench import devtrace
            self._prof = devtrace.start()
        self.sync()
        self._t0 = time.perf_counter()
        self.setup_s = self._t0 - self.t_process
        try:
            yield self._t0
        finally:
            if self.record.window_s == 0.0:
                self.close()

    def note(self, phase: str) -> None:
        """Log on standard error when a phase of the run ended, in seconds
        since the process started."""
        print(f"perfbench: {phase} done at "
              f"{time.perf_counter() - self.t_process:.2f} s",
              file=sys.stderr, flush=True)

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> float:
        """Close the window: wait for the device, read the peak memory and
        stop the profiler.  Returns the window's seconds."""
        import torch
        self.sync()
        self.record.window_s = time.perf_counter() - self._t0
        self.memory_peak_bytes = (max(torch.cuda.max_memory_allocated(d)
                                      for d in range(self.cell.chips))
                                  if self.device.type == "cuda" else 0)
        if self._prof is not None:
            from perfbench import devtrace
            self.record.timeline = devtrace.stop(self._prof)
            self._prof = None
        return self.record.window_s


def free_device(device) -> None:
    """Return what freed tensors held to the device, before the reference
    runs in their place."""
    import gc

    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def _parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, root: str, t_process: float) -> int:
    args = _parse(argv)
    root = Path(root)
    cell = resolve(load_spec(root), root, args.workload)
    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"perfbench: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), t_process)
    out = driver_for(root, cell).run(ctx)
    found = forbidden_loaded()
    if found:
        print(f"perfbench: the measured process loaded {found}",
              file=sys.stderr)
        return 3
    return emit(ctx, out, root)


def emit(ctx: Context, out: Outcome, root: Path) -> int:
    """Print the checks on standard error and the result line last on
    standard output."""
    import torch
    cell = ctx.cell
    metrics = {}
    if ctx.trace:
        for m in cell.per_layer:
            v = reader_for(root, m["name"]).read(ctx.record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out.values, setup_s=ctx.setup_s)
        for m in cell.end_to_end:
            if m["name"] in values and values[m["name"]] is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": ctx.memory_peak_bytes}
    line = {"correct": bool(out.checks) and all(c.ok for c in out.checks),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    tl = ctx.record.timeline
    if tl is not None:
        device["busy_s"] = tl.busy_s
        device["window_s"] = ctx.record.window_s
        line["breakdown"] = tl.breakdown()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    for name, v in out.notes.items():
        print(f"note {name} {v!r} (not compared)", file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
