"""Model FLOPs of the traced offline call (as the cell's architecture
counts them) over its wall time and the bf16 peak, in %."""

from portbench import roofline


def read(rec: dict):
    prof = rec.get("profile")
    if not prof or not prof.get("calls") or prof["window_s"] <= 0:
        return None
    hp, arch = rec["shape"]["hp"], rec["arch"]
    flops = 0.0
    for call in prof["calls"]:
        flops += arch.offline_call_flops(
            hp, [f["n"] for f in call["batch"]],
            arch.max_seg_mel_frames(hp),
            [s["iterations"] for s in call["stats"]])
    return 100.0 * flops / prof["window_s"] / roofline.PEAK_BF16_FLOPS
