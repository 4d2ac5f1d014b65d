"""Share of the window's offline call time outside the device's work, in
%: 1 less the seconds of the segments' encoder launches and decode loops
(the program's `offline.encoder` and `offline.decode` spans, which
ASRModel.offline_stats carries per segment) over the calls' seconds. What
is left is the calls' host steps: the mel and its copy back, the padding,
the uploads, the tokens' copy back and lists, the detokenizer.

Over every call of the window but the traced one (--trace 1: the
profiler slows its host steps), which kinds/offline.py keeps, with its
segments' stats, as the profile's "calls". None where the program's stats
carry no such seconds."""


def read(rec: dict):
    traced = (rec.get("profile") or {}).get("calls", [])
    skip = {id(s) for c in traced for s in c["stats"]}
    segs = [s for s in rec.get("offline_stats") or () if id(s) not in skip]
    if not segs or any("decode_seconds" not in s for s in segs):
        return None
    call_s = rec["offline_call_s"] - sum(c["seconds"] for c in traced)
    device = sum(s["encoder_seconds"] + s["decode_seconds"] for s in segs)
    return 100.0 * (1.0 - device / call_s) if call_s > 0 else None
