"""Model FLOPs of the traced stretch over its wall time and the bf16
peak, in %."""

from portbench import readers


def read(rec: dict):
    return readers.stream_mfu(rec)
