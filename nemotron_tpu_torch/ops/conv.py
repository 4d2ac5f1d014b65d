"""Convolutions: causal conv2d subsampling stack + streaming depthwise conv1d
(port of nemotron_tpu/ops/conv.py).

The 3x3 convs run through torch.nn.functional.conv2d (cuDNN on the card —
the package turns TF32 off, see nemotron_tpu_torch/api.py) in NCHW with
the reference's asymmetric causal padding (k-1, s-1) on both spatial axes.
The public functions keep the JAX package's layouts: mel [B, T, n_mels]
in, [B, T', d_model] out, conv caches [B, K-1, D].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .basic import linear


def _causal_pad(x, kh: int, kw: int, stride: int):
    """x [B, C, H, W]: pad (k-1, s-1) on H and W."""
    return F.pad(x, (kw - 1, stride - 1, kh - 1, stride - 1))


def causal_conv2d(x, w, b, stride: int):
    """x: [B, C_in, H, W]; w: (OC, IC, KH, KW). Full causal conv."""
    kh, kw = w.shape[2], w.shape[3]
    return F.conv2d(_causal_pad(x, kh, kw, stride), w, b, stride=stride)


def causal_dw_conv2d(x, w, b, stride: int):
    """Depthwise causal conv: x [B, C, H, W]; w (C, 1, KH, KW)."""
    kh, kw = w.shape[2], w.shape[3]
    return F.conv2d(_causal_pad(x, kh, kw, stride), w, b, stride=stride,
                    groups=w.shape[0])


def conv_subsampling(sub, mel):
    """Depthwise-separable 8x subsampling. mel: [B, T, n_mels] -> [B, T', d_model].

    Flatten order matches the reference: flat index = c * W_out + w
    (nemotron_tpu/ops/conv.py:129-131). Streaming chunks are always exact
    length, so the ragged-batch masking of the offline path is not needed.
    """
    x = mel.to(sub.conv0_w.dtype)[:, None]  # [B, 1, H=T, W=mels]
    x = torch.relu(causal_conv2d(x, sub.conv0_w, sub.conv0_b, 2))
    x = causal_dw_conv2d(x, sub.conv2_w, sub.conv2_b, 2)
    x = torch.relu(F.conv2d(x, sub.conv3_w, sub.conv3_b))  # pointwise
    x = causal_dw_conv2d(x, sub.conv5_w, sub.conv5_b, 2)
    x = torch.relu(F.conv2d(x, sub.conv6_w, sub.conv6_b))
    b, c, ho, wo = x.shape
    flat = x.permute(0, 2, 1, 3).reshape(b, ho, c * wo)
    return linear(flat, sub.out_w, sub.out_b)


def depthwise_causal_conv1d(x, dw_w, cache=None):
    """Causal depthwise conv over time.

    x: [B, T, D]; dw_w: [K, D] (kernel-major, as stored in the GGUF);
    cache: [B, K-1, D] carried left context, or None for zero-pad.
    Returns (y [B, T, D], new_cache [B, K-1, D]).
    """
    k = dw_w.shape[0]
    t = x.shape[1]
    if cache is None:
        cache = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    padded = torch.cat([cache, x], dim=1)  # [B, K-1+T, D]
    if t == 1:
        y = torch.einsum("bkd,kd->bd", padded, dw_w)[:, None, :]
    else:  # the taps summed in f32 and rounded once, as the T=1 einsum
        p32, w32 = padded.float(), dw_w.float()
        y = p32[:, 0:t, :] * w32[0]
        for i in range(1, k):
            y = y + p32[:, i:i + t, :] * w32[i]
        y = y.to(x.dtype)
    return y, padded[:, t:, :]
