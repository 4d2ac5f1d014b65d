"""Harness clock around every BatchedEngine.tick() of the window: total
over ticks."""


def read(rec: dict):
    ticks = rec.get("tick_s")
    return 1e3 * sum(ticks) / len(ticks) if ticks else None
