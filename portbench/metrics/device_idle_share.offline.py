"""Share of the traced stretch in which no operation ran on the card."""

from portbench import readers


def read(rec: dict):
    return readers.idle_share(rec)
