"""Decode loop iterations per encoder frame of the window's segments
(ASRModel.offline_stats: iterations over the frames of each segment's
padded mel, subsampled as the cell's architecture does)."""


def read(rec: dict):
    stats = rec.get("offline_stats")
    if not stats:
        return None
    frames = sum(rec["arch"].subsampled_len(s["mel_frames"]) for s in stats)
    return sum(s["iterations"] for s in stats) / frames
