"""Elementwise / normalization / FFN primitives (port of nemotron_tpu/ops/basic.py).

layer_norm normalises with the population variance and eps inside the
square root; linear weights are in PyTorch (out, in) order; the FFN is
Linear -> SiLU -> Linear without biases.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(x, w, b, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def linear(x, w, b=None):
    """x @ w.T (+ b) with w in (out, in) order: a dense tensor, or a
    QuantizedTensor / QuantizedTensor4 (weight-only Q8_0 / Q4_0,
    dequantized inside kernel B4 / B5)."""
    if isinstance(w, torch.Tensor):
        return F.linear(x, w, b)
    from .quant import QuantizedTensor, linear_q4, linear_q8

    y = linear_q8(x, w) if isinstance(w, QuantizedTensor) else linear_q4(x, w)
    return y if b is None else y + b


def ffn(x, w1, w2):
    return linear(F.silu(linear(x, w1)), w2)


def glu(x):
    """Gated linear unit over the last axis (first half * sigmoid(second half))."""
    a, b = torch.chunk(x, 2, dim=-1)
    return a * torch.sigmoid(b)


def tp_sum(parts, device):
    """The partial products of a matmul split on its input axis over a dp
    shard's tp devices (parallel/mesh.py), summed in rank order (0, 1,
    ...) on `device`, so the sum does not depend on the streams the parts
    were made on. The tp layers (models/encoder._tp_layer) call it after
    the join (TPGroup.each: the lead waits for every rank stream), each
    rank having copied its part to `device` on its own stream; another
    caller's part on another device is copied here."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out
