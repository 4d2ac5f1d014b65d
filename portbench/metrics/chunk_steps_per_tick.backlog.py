"""Chunk steps per tick over the window, from the engine's counters
(stats(): chunk_steps over ticks)."""


def read(rec: dict):
    c = rec.get("window_counters")
    return c["chunk_steps"] / c["ticks"] if c and c["ticks"] else None
