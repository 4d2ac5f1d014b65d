"""T=1 streaming attention core: the CUDA kernel `csrc/t1_attention.cu` and
its plain PyTorch version (port of nemotron_tpu/ops/attn_pallas.py, kernel B1).

    scores  = (q_u . [K_buf; k_new]) * scale + pos_mask     (f32)
    weights = softmax(scores)                               (f32)
    ctx     = weights . [V_buf; v_new]

K_buf / V_buf are dense tensors, or int8 `QuantKV` caches read as they are
(JAX ops/rel_attention.py:_t1_scores / _t1_context): the K scale multiplies
each score after the Dh reduction, the V scale multiplies the softmax
weight, and no dequantized copy of the cache is made.

A CUDA tensor goes through the kernel (or the call raises); a CPU tensor
takes `t1_attention_core_ref`.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from .kvquant import is_quant

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def t1_attention_core_ref(q_u, k_new, v_new, pos_mask, k_buf, v_buf):
    """Plain PyTorch version.

    q_u, k_new, v_new: [B, H, Dh]; pos_mask: [B, H, S_buf + 1] f32 (position
    scores * scale + additive mask); k_buf, v_buf: [B, H, S_buf, Dh] (read
    only), dense or QuantKV. Returns ctx [B, H, Dh] in q_u's dtype."""
    scale = 1.0 / math.sqrt(q_u.shape[-1])
    q = q_u.float()
    if is_quant(k_buf):
        content = torch.einsum("bhd,bhsd->bhs", q, k_buf.q.float()) * k_buf.s
    else:
        content = torch.einsum("bhd,bhsd->bhs", q, k_buf.float())
    c_new = (q * k_new.float()).sum(-1, keepdim=True)
    scores = torch.cat([content, c_new], dim=-1) * scale + pos_mask.float()
    w = torch.softmax(scores, dim=-1)
    if is_quant(v_buf):
        ctx = torch.einsum("bhs,bhsd->bhd", w[..., :-1] * v_buf.s,
                           v_buf.q.float())
    else:
        ctx = torch.einsum("bhs,bhsd->bhd", w[..., :-1], v_buf.float())
    ctx = ctx + w[..., -1:] * v_new.float()
    return ctx.to(q_u.dtype)


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device:
        raise ValueError(
            f"t1_attention_core: {name} {tuple(t.shape)} {t.dtype} on "
            f"{t.device}, want {tuple(shape)} {dtype} on {device}")


def t1_attention_core(q_u, k_new, v_new, pos_mask, k_buf, v_buf):
    """Fused T=1 attention against the full slack buffer (kernel on CUDA)."""
    quant = is_quant(k_buf)
    if quant != is_quant(v_buf):
        raise ValueError("t1_attention_core: K and V caches differ in kind")
    dev = (k_buf.q if quant else k_buf).device
    if dev.type == "cpu":
        return t1_attention_core_ref(q_u, k_new, v_new, pos_mask, k_buf, v_buf)
    if dev.type != "cuda":
        raise ValueError(f"t1_attention_core: unsupported device {dev}")
    dt = q_u.dtype
    if dt not in _SUFFIX:
        raise ValueError(f"t1_attention_core: unsupported dtype {dt}")
    b, h, dh = q_u.shape
    if quant:
        s_buf = k_buf.q.shape[2]
        caches = (k_buf.q, k_buf.s, v_buf.q, v_buf.s)
        for name, t in zip(("k_buf.q", "k_buf.s", "v_buf.q", "v_buf.s"),
                           caches):
            shape = (b, h, s_buf, dh) if name.endswith("q") else (b, h, s_buf)
            _check(name, t, shape,
                   torch.int8 if name.endswith("q") else torch.float32, dev)
        if dh % 4 or dh > 128:  # one 4-byte code group per lane of a warp
            raise ValueError(
                f"t1_attention_core: int8 caches need d_head % 4 == 0 and "
                f"d_head <= 128, got {dh}")
    else:
        s_buf = k_buf.shape[2]
        caches = (k_buf, v_buf)
        for name, t in (("k_buf", k_buf), ("v_buf", v_buf)):
            _check(name, t, (b, h, s_buf, dh), dt, dev)
    for name, t, shape, want in (
            ("q_u", q_u, (b, h, dh), dt), ("k_new", k_new, (b, h, dh), dt),
            ("v_new", v_new, (b, h, dh), dt),
            ("pos_mask", pos_mask, (b, h, s_buf + 1), torch.float32)):
        _check(name, t, shape, want, dev)
    if not all(t.is_contiguous() for t in caches):
        raise ValueError("t1_attention_core: K/V buffers must be contiguous")
    q_u, k_new, v_new, pos_mask = (t.contiguous() for t in
                                   (q_u, k_new, v_new, pos_mask))
    out = torch.empty((b, h, dh), dtype=dt, device=dev)
    symbol = ("t1_attention_i8_" if quant else "t1_attention_") + _SUFFIX[dt]
    kernels.T1_ATTENTION.launch(
        symbol, q_u.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        pos_mask.data_ptr(), *(t.data_ptr() for t in caches), out.data_ptr(),
        b * h, s_buf, dh, 1.0 / math.sqrt(dh))
    return out
