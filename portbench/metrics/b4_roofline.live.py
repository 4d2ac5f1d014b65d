"""Kernel B4 (Q8_0 linears) in the traced stretch: the sum of the
operations' bounds over the sum of its kernels' time, in %."""

from portbench import readers


def read(rec: dict):
    return readers.b4_share(rec)
