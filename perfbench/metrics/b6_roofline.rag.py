"""Kernel B6's share of its roofline: the SSD scan of each admission's real prompt tokens in every Mamba layer (perfbench/hybrid_cost.py) over the device time of B6's three kernels."""
from perfbench import layer

B6 = ("ssd_state_tc_kernel", "ssd_pass_kernel", "ssd_out_tc_kernel")


def read(rec):
    return layer.kernel_roofline(rec, "b6_bound_s", B6)
