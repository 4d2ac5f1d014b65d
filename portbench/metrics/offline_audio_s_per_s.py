"""Audio of every file of the window's calls over the time the calls
took."""


def read(rec: dict):
    a = rec.get("offline_audio_s")
    return a / rec["offline_call_s"] if a is not None else None
