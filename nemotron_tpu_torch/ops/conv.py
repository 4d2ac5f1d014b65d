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


def _mask_valid_h(x, valid):
    """Zero the time positions >= valid ([B] int) of x [B, C, H=T, W].

    Each stride-2 level's right pad is (s-1) = 1, so the last output frame
    of an exact-length run reads one position past its end: a pad zero. In
    a zero-padded ragged batch that position holds a computed value (the
    conv bias and relu turn zero input into constants), so without this
    mask the boundary frame differs from the exact-length run and attention
    spreads the difference to every frame. Zeroing each level at its
    exact-length width makes the valid prefix bit-equal to that run
    (nemotron_tpu/ops/conv.py:_mask_valid_h, in NHWC there)."""
    pos = torch.arange(x.shape[2], device=x.device)
    keep = pos[None, :] < valid[:, None].to(pos.dtype)
    return torch.where(keep[:, None, :, None], x, x.new_zeros(()))


def conv_subsampling(sub, mel, n_frames=None):
    """Depthwise-separable 8x subsampling. mel: [B, T, n_mels] -> [B, T', d_model].

    Flatten order matches the reference: flat index = c * W_out + w
    (nemotron_tpu/ops/conv.py:129-131).

    n_frames: optional [B] valid MEL frames of a zero-padded ragged batch
    (the offline path). Each stride-2 level is then masked to its
    exact-length output width (t -> t // 2 + 1, `_mask_valid_h`), so each
    row's valid prefix equals its exact-length run. Streaming chunks are
    always exact length and pass None.
    """
    valid = None if n_frames is None else n_frames.to(torch.int64)

    def level(x):
        nonlocal valid
        if valid is None:
            return x
        valid = valid // 2 + 1
        return _mask_valid_h(x, valid)

    x = mel.to(sub.conv0_w.dtype)[:, None]  # [B, 1, H=T, W=mels]
    x = level(torch.relu(causal_conv2d(x, sub.conv0_w, sub.conv0_b, 2)))
    x = causal_dw_conv2d(x, sub.conv2_w, sub.conv2_b, 2)
    x = level(torch.relu(F.conv2d(x, sub.conv3_w, sub.conv3_b)))  # pointwise
    x = causal_dw_conv2d(x, sub.conv5_w, sub.conv5_b, 2)
    x = level(torch.relu(F.conv2d(x, sub.conv6_w, sub.conv6_b)))
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
