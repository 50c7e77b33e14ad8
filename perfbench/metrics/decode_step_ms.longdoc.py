"""Median host ms of the engine steps that admitted nothing (one decode wave, ending in its host copy)."""
from perfbench import layer


def read(rec):
    return layer.decode_step_ms(rec)
