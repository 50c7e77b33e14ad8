"""Kernel B4's share of its roofline: causal attention over the real prompt lengths (window-capped where the model has a window) over B4's device time."""
from perfbench import layer


def read(rec):
    return layer.kernel_roofline(rec, "b4_bound_s", layer.B4)
