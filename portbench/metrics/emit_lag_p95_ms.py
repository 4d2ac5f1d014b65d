"""95th percentile of the lag of every text event returned in the
window (kinds/live.py: return time less the time its audio was due)."""

from portbench import readers


def read(rec: dict):
    return readers.percentile_ms(rec.get("lags_s", ()), 95)
