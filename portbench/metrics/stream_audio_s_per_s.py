"""Stream audio read back in the window (every stream's progress),
over the window."""


def read(rec: dict):
    a = rec.get("stream_audio_s")
    return a / rec["window_s"] if a is not None else None
