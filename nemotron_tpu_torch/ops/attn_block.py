"""The fused T=1 attention block of one conformer layer: the CUDA kernel
`csrc/t1_attention_block.cu` and its plain PyTorch version (port of
nemotron_tpu/ops/attn_block_pallas.py, kernel B3).

    y        = LN(x)                                   (f32, cast to x's type)
    q, k, v  = y . Wq^T, y . Wk^T, y . Wv^T            (f32 sums; q stays f32)
    scores   = content * scale + ((q + bias_v) . pp + new-frame score) * scale
               + mask                                  (f32)
    ctx      = softmax(scores) . [V_buf; v]            (f32, cast to x's type)
    out      = x + ctx . Wo^T                          (f32 sum, cast once)

Returns (out [B, D], k_new, v_new [B, H, Dh] in x's type); the caller
appends k_new / v_new to the cache. K_buf / V_buf are dense tensors, or
int8 `QuantKV` caches read as they are, as kernel B1 reads them
(ops/attn_kernel.py): the K scale multiplies each content score after the
Dh reduction and the V scale multiplies the softmax weight. The JAX
package dequantizes first; the values agree up to rounding order.

A CUDA tensor goes through the kernel (or the call raises); a CPU tensor
takes `t1_attention_block_ref`.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from .kvquant import is_quant

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def t1_attention_block_ref(x, ln_w, ln_b, q_w, k_w, v_w, out_w, bias_u,
                           bias_v, pp, mask, k_buf, v_buf, n_heads: int,
                           d_head: int, eps: float = 1e-5):
    """Plain PyTorch version, with the Pallas kernel's rounding points.

    x [B, D]; ln_w/ln_b [D]; q/k/v/out_w [D, D] (out, in); bias_u/v [H, Dh];
    pp [H, Dh, S_buf + 1] f32; mask [B, S_buf + 1] additive; k_buf/v_buf
    [B, H, S_buf, Dh] dense or QuantKV (read only)."""
    B, D = x.shape
    H, Dh = n_heads, d_head
    dt = x.dtype
    scale = 1.0 / math.sqrt(Dh)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps) * ln_w.float()
         + ln_b.float()).to(dt).float()
    q = (y @ q_w.float().T).view(B, H, Dh)
    kn = (y @ k_w.float().T).view(B, H, Dh)
    vn = (y @ v_w.float().T).view(B, H, Dh)
    q_u = q + bias_u.float()
    q_v = q + bias_v.float()
    nsc = (q_u * kn).sum(-1)                                  # [B, H]
    pos = torch.einsum("bhd,hds->bhs", q_v, pp.float())       # [B, H, S+1]
    pos[..., -1] += nsc
    pos = pos * scale + mask.float()[:, None, :]
    if is_quant(k_buf):
        content = torch.einsum("bhd,bhsd->bhs", q_u, k_buf.q.float()) \
            * k_buf.s
    else:
        content = torch.einsum("bhd,bhsd->bhs", q_u, k_buf.float())
    scores = torch.cat([content, torch.zeros_like(nsc)[..., None]], -1) \
        * scale + pos
    w = torch.softmax(scores, dim=-1)
    if is_quant(v_buf):
        ctx = torch.einsum("bhs,bhsd->bhd", w[..., :-1] * v_buf.s,
                           v_buf.q.float())
    else:
        ctx = torch.einsum("bhs,bhsd->bhd", w[..., :-1], v_buf.float())
    ctx = ctx + w[..., -1:] * vn
    out = xf + ctx.to(dt).float().reshape(B, D) @ out_w.float().T
    return out.to(dt), kn.to(dt), vn.to(dt)


def _check(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor) or tuple(t.shape) != tuple(shape) \
            or t.dtype != dtype or t.device != device:
        desc = (f"{tuple(t.shape)} {t.dtype} on {t.device}"
                if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"t1_attention_block: {name} {desc}, want "
                         f"{tuple(shape)} {dtype} on {device}")


def t1_attention_block(x, ln_w, ln_b, q_w, k_w, v_w, out_w, bias_u, bias_v,
                       pp, mask, k_buf, v_buf, n_heads: int, d_head: int,
                       eps: float = 1e-5):
    """The fused attention block for one layer at T=1 (kernel on CUDA).
    Returns (x + attn [B, D], k_new [B, H, Dh], v_new [B, H, Dh])."""
    quant = is_quant(k_buf)
    if quant != is_quant(v_buf):
        raise ValueError("t1_attention_block: K and V caches differ in kind")
    dev = x.device
    if dev.type == "cpu":
        return t1_attention_block_ref(x, ln_w, ln_b, q_w, k_w, v_w, out_w,
                                      bias_u, bias_v, pp, mask, k_buf, v_buf,
                                      n_heads, d_head, eps)
    if dev.type != "cuda":
        raise ValueError(f"t1_attention_block: unsupported device {dev}")
    dt = x.dtype
    if dt not in _SUFFIX:
        raise ValueError(f"t1_attention_block: unsupported dtype {dt}")
    B, D = x.shape
    H, Dh = n_heads, d_head
    if H * Dh != D or D % 32:  # the GEMMs walk K in steps of 32
        raise ValueError(f"t1_attention_block: d_model {D} must be "
                         f"n_heads * d_head = {H * Dh} and a multiple of 32")
    if quant:
        s_buf = k_buf.q.shape[2]
        caches = (k_buf.q, k_buf.s, v_buf.q, v_buf.s)
        for name, t in zip(("k_buf.q", "k_buf.s", "v_buf.q", "v_buf.s"),
                           caches):
            code = name.endswith("q")
            _check(name, t, (B, H, s_buf, Dh) if code else (B, H, s_buf),
                   torch.int8 if code else torch.float32, dev)
        if Dh % 4 or Dh > 128:  # one 4-byte code group per lane of a warp
            raise ValueError(
                f"t1_attention_block: int8 caches need d_head % 4 == 0 and "
                f"d_head <= 128, got {Dh}")
    else:
        s_buf = k_buf.shape[2]
        caches = (k_buf, v_buf)
        for name, t in (("k_buf", k_buf), ("v_buf", v_buf)):
            _check(name, t, (B, H, s_buf, Dh), dt, dev)
    for name, t, shape, want in (
            ("ln_w", ln_w, (D,), dt), ("ln_b", ln_b, (D,), dt),
            ("q_w", q_w, (D, D), dt), ("k_w", k_w, (D, D), dt),
            ("v_w", v_w, (D, D), dt), ("out_w", out_w, (D, D), dt),
            ("bias_u", bias_u, (H, Dh), dt), ("bias_v", bias_v, (H, Dh), dt),
            ("pp", pp, (H, Dh, s_buf + 1), torch.float32),
            ("mask", mask, (B, s_buf + 1), dt)):
        _check(name, t, shape, want, dev)
    if not all(t.is_contiguous() for t in caches):
        raise ValueError("t1_attention_block: K/V buffers must be contiguous")
    ins = [t.contiguous() for t in (x, ln_w, ln_b, q_w, k_w, v_w, out_w,
                                    bias_u, bias_v, pp, mask)]
    out = torch.empty((B, D), dtype=dt, device=dev)
    k_new = torch.empty((B, H, Dh), dtype=dt, device=dev)
    v_new = torch.empty((B, H, Dh), dtype=dt, device=dev)
    qkv = torch.empty((B, 3 * D), dtype=torch.float32, device=dev)
    ctx = torch.empty((B, D), dtype=dt, device=dev)
    symbol = ("t1_attention_block_i8_" if quant
              else "t1_attention_block_") + _SUFFIX[dt]
    kernels.T1_ATTENTION_BLOCK.launch(
        symbol, *(t.data_ptr() for t in ins), *(t.data_ptr() for t in caches),
        *(t.data_ptr() for t in (out, k_new, v_new, qkv, ctx)),
        B, H, s_buf, Dh, eps, 1.0 / math.sqrt(Dh))
    return out, k_new, v_new
