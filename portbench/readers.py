"""What the metric readers (portbench/metrics/*.py) share. A reader gets the
run's record and returns its number, or None where the run gives it
nothing to read (then the harness leaves the metric out of the line)."""

from __future__ import annotations

import re

import numpy as np

from . import roofline


def percentile_ms(values, q: float):
    v = np.asarray(values, dtype=np.float64)
    return float(np.percentile(v, q)) * 1e3 if v.size else None


def kernel_seconds(rec: dict, op: str):
    """Device seconds of the traced stretch's kernels that do `op`
    (kernels/*.json), and their launches; None without a trace or such a
    kernel."""
    prof = rec.get("profile")
    pats = rec["kernel_ops"].get(op)
    if not prof or not pats:
        return None
    rx = re.compile("|".join(r"(?<![A-Za-z0-9_])%s(?![A-Za-z0-9_])"
                             % re.escape(p) for p in pats))
    secs = n = 0
    for name, (s, k) in prof["kernels"].items():
        if rx.search(name):
            secs += s
            n += k
    return (secs, n) if n else None


def share(bound_s: float, seconds: float):
    return 100.0 * bound_s / seconds if seconds > 0 else None


def idle_share(rec: dict):
    prof = rec.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def stream_mfu(rec: dict):
    """Model FLOPs of the traced stretch's chunk steps (every active
    stream's chunk, and once per chunk step what all streams share; the
    cell's architecture counts them) over its wall time and the bf16
    peak."""
    prof, shape, arch = rec.get("profile"), rec.get("shape"), rec["arch"]
    if not prof or "counters" not in prof or prof["window_s"] <= 0:
        return None
    hp, rc = shape["hp"], shape["right_context"]
    c = prof["counters"]
    flops = c["chunks"] * arch.stream_chunk_flops(hp, rc) \
        + c["chunk_steps"] * arch.stream_step_flops(hp, rc)
    return 100.0 * flops / prof["window_s"] / roofline.PEAK_BF16_FLOPS


def b4_share(rec: dict):
    """Q8_0 linears of the traced chunk steps: the sum of their bounds
    over the sum of their kernels' time."""
    ks = kernel_seconds(rec, "q8_linear")
    fields = rec["cell"]["config"].get("q8_0_fields")
    if ks is None or not fields or "counters" not in rec["profile"]:
        return None
    shape = rec["shape"]
    calls = rec["arch"].stream_linear_calls(shape["hp"], fields,
                                            shape["slots"],
                                            shape["right_context"])
    per_step = sum(roofline.bound_s(*roofline.q8_linear(*c)) for c in calls)
    return share(rec["profile"]["counters"]["chunk_steps"] * per_step, ks[0])


def b1_share(rec: dict):
    """T=1 attention of the traced chunk steps (every layer, every slot)."""
    ks = kernel_seconds(rec, "t1_attention")
    if ks is None or "counters" not in rec["profile"]:
        return None
    shape = rec["shape"]
    calls = rec["arch"].stream_attention_calls(shape["hp"], shape["slots"],
                                               shape["right_context"])
    if calls is None:
        return None
    n, args = calls
    one = roofline.bound_s(*roofline.t1_attention(*args))
    steps = rec["profile"]["counters"]["chunk_steps"]
    return share(steps * n * one, ks[0])
