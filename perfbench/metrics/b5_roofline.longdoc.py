"""Kernel B5's share of its roofline: each live sequence's real cache (window-capped where the model has a window), query and output once over B5's device time."""
from perfbench import layer


def read(rec):
    return layer.kernel_roofline(rec, "b5_bound_s", layer.B5)
