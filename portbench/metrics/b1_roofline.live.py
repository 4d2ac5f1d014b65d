"""Kernel B1 (T=1 attention) in the traced stretch: the sum of the
operations' bounds over the sum of its kernels' time, in %."""

from portbench import readers


def read(rec: dict):
    return readers.b1_share(rec)
