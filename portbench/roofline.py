"""The yardstick that holds for every model: the card's peaks, and the
operations and bytes of each operation a kernel does, from shapes. A
model's own FLOPs are its architecture's (archs/<arch>/counts.py).

A kernel's bound counts the work of the operation, not of the kernel that
does it, so that a rewrite of the kernel is read against the same
yardstick: each input read once and each output written once, and for
attention the live window of keys (left context + the chunk), whatever
buffer holds it. The bound is max(bytes / HBM rate, operations / peak).

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit: 989 TFLOP/s
in bf16 on the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
Q8_0_BYTES_PER_WEIGHT = 34 / 32   # a block: 32 int8 codes and an fp16 scale


def bound_s(ops: float, nbytes: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16_FLOPS)


def q8_linear(m: int, n: int, k: int, act_bytes: int = 2):
    """y [m, n] = x [m, k] @ W.T, W Q8_0 [n, k]: (operations, bytes)."""
    return 2.0 * m * n * k, n * k * Q8_0_BYTES_PER_WEIGHT + (m * k + m * n) \
        * act_bytes


def t1_attention(b: int, h: int, s: int, dh: int, act_bytes: int = 2):
    """One query per stream and head against s keys: (operations, bytes):
    the scores and the context, 4 b h s dh; K and V read once, q, the new
    k and v and the output once each."""
    return 4.0 * b * h * s * dh, (2 * b * h * s * dh + 4 * b * h * dh) \
        * act_bytes
