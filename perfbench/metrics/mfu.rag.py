"""The window's real tokens' operations over the summed step walls at the bf16 peak, in %."""
from perfbench import layer


def read(rec):
    return layer.mfu(rec)
