"""Median lag of the window's text events (as emit_lag_p95_ms)."""

from portbench import readers


def read(rec: dict):
    return readers.percentile_ms(rec.get("lags_s", ()), 50)
