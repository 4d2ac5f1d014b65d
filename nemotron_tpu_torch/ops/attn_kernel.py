"""T=1 streaming attention core: the CUDA kernel `csrc/t1_attention.cu` and
its plain PyTorch version (port of nemotron_tpu/ops/attn_pallas.py, kernel B1).

    scores  = (q_u . [K_buf; k_new]) * scale + pos_mask     (f32)
    weights = softmax(scores)                               (f32)
    ctx     = weights . [V_buf; v_new]

A CUDA tensor goes through the kernel (or the call raises); a CPU tensor
takes `t1_attention_core_ref`.
"""

from __future__ import annotations

import math

import torch

from .. import kernels

_SYMBOL = {torch.float32: "t1_attention_f32",
           torch.bfloat16: "t1_attention_bf16"}


def t1_attention_core_ref(q_u, k_new, v_new, pos_mask, k_buf, v_buf):
    """Plain PyTorch version.

    q_u, k_new, v_new: [B, H, Dh]; pos_mask: [B, H, S_buf + 1] f32 (position
    scores * scale + additive mask); k_buf, v_buf: [B, H, S_buf, Dh] (read
    only). Returns ctx [B, H, Dh] in k_buf's dtype."""
    scale = 1.0 / math.sqrt(q_u.shape[-1])
    q = q_u.float()
    content = torch.einsum("bhd,bhsd->bhs", q, k_buf.float())
    c_new = (q * k_new.float()).sum(-1, keepdim=True)
    scores = torch.cat([content, c_new], dim=-1) * scale + pos_mask.float()
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhs,bhsd->bhd", w[..., :-1], v_buf.float())
    ctx = ctx + w[..., -1:] * v_new.float()
    return ctx.to(k_buf.dtype)


def t1_attention_core(q_u, k_new, v_new, pos_mask, k_buf, v_buf):
    """Fused T=1 attention against the full slack buffer (kernel on CUDA)."""
    if k_buf.device.type == "cpu":
        return t1_attention_core_ref(q_u, k_new, v_new, pos_mask, k_buf, v_buf)
    if k_buf.device.type != "cuda":
        raise ValueError(f"t1_attention_core: unsupported device {k_buf.device}")
    b, h, s_buf, dh = k_buf.shape
    dt = k_buf.dtype
    if dt not in _SYMBOL:
        raise ValueError(f"t1_attention_core: unsupported dtype {dt}")
    for name, t, shape, want in (
            ("q_u", q_u, (b, h, dh), dt), ("k_new", k_new, (b, h, dh), dt),
            ("v_new", v_new, (b, h, dh), dt), ("v_buf", v_buf, k_buf.shape, dt),
            ("pos_mask", pos_mask, (b, h, s_buf + 1), torch.float32)):
        if tuple(t.shape) != tuple(shape) or t.dtype != want \
                or t.device != k_buf.device:
            raise ValueError(
                f"t1_attention_core: {name} {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, want {tuple(shape)} {want} on {k_buf.device}")
    if not (k_buf.is_contiguous() and v_buf.is_contiguous()):
        raise ValueError("t1_attention_core: K/V buffers must be contiguous")
    q_u, k_new, v_new, pos_mask = (t.contiguous() for t in
                                   (q_u, k_new, v_new, pos_mask))
    out = torch.empty((b, h, dh), dtype=dt, device=k_buf.device)
    kernels.T1_ATTENTION.launch(
        _SYMBOL[dt], q_u.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        pos_mask.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(),
        out.data_ptr(), b * h, s_buf, dh, 1.0 / math.sqrt(dh))
    return out
