"""Seconds the program spent capturing CUDA graphs in set-up
(graphs.stats() capture_seconds when the window opens)."""


def read(rec: dict):
    return rec.get("graph_capture_s")
