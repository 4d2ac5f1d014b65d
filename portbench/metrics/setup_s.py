"""Process start to the window's start: torch and the card, the
weights, the engine and its graph captures, the warm-up traffic."""


def read(rec: dict):
    return rec.get("setup_s")
