"""Arithmetic the per-layer readers share (each metric's reader is its own
file under ``perfbench/metrics/``).  A reader returns None where the run
has nothing for it to read, never 0 for a share."""
from __future__ import annotations

from perfbench import cost

B4 = ("prefill_tc_kernel",)
B5 = ("decode_split_kernel", "decode_merge_kernel")


def share(bound_s, timeline, kernels) -> float | None:
    """100 x the work's least time over the kernels' device time."""
    if timeline is None or not bound_s:
        return None
    t = timeline.device_s(*kernels)
    return 100.0 * bound_s / t if t > 0 else None


def idle_share(rec) -> float | None:
    """The share of the traced window in which no operation ran on the
    device, in %."""
    if rec.timeline is None or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.timeline.busy_s / rec.window_s)


def kernel_roofline(rec, bound_key: str, kernels) -> float | None:
    return share(rec.counters.get(bound_key), rec.timeline, kernels)


def mfu(rec, flops_key: str = "flops", wall_key: str = "step_wall_s"
        ) -> float | None:
    """The operations the window's real tokens need over the summed wall
    of the steps at the bf16 peak, in %."""
    f, wall = rec.counters.get(flops_key), rec.counters.get(wall_key)
    if not f or not wall:
        return None
    return 100.0 * f / (wall * cost.PEAK_BF16_FLOP_S)


def decode_step_ms(rec) -> float | None:
    s = rec.counters.get("decode_step_s")
    return None if s is None else 1e3 * s
