"""The device's idle share of the traced window, in %."""
from perfbench import layer


def read(rec):
    return layer.idle_share(rec)
