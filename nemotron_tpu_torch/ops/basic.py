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
    """x @ w.T (+ b) with w in (out, in) order."""
    return F.linear(x, w, b)


def ffn(x, w1, w2):
    return linear(F.silu(linear(x, w1)), w2)


def glu(x):
    """Gated linear unit over the last axis (first half * sigmoid(second half))."""
    a, b = torch.chunk(x, 2, dim=-1)
    return a * torch.sigmoid(b)
