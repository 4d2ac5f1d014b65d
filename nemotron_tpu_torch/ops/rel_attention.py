"""Relative-position multi-head attention over the phased slack buffer
(port of nemotron_tpu/ops/rel_attention.py:rel_pos_mha_fullbuf at T=1).

Scores are computed against ALL S_buf cache slots plus the new frame; the
phase's slot -> relative-position map arrives as `pos_index` (an index
gather in place of the JAX package's one-hot contraction: the same values)
and the window/validity selection as the additive `attn_mask` (-1e9 on
dead slots, whose softmax weight is exactly 0).
"""

from __future__ import annotations

import math

import torch

from .attn_kernel import t1_attention_core
from .basic import linear


def rel_pos_mha_fullbuf(x, pos_emb, q_w, k_w, v_w, pos_w, out_w, bias_u,
                        bias_v, n_heads: int, d_head: int, k_buf, v_buf,
                        pos_index, attn_mask):
    """Streaming rel-pos MHA for one new frame (chunk_len 1).

    x: [B, 1, D]; pos_emb: [pos_len, D]; k_buf/v_buf: [B, H, S_buf, Dh]
    head-major per-layer cache views (read only), dense or int8 QuantKV;
    the weights are dense or quantized (ops/basic.linear); pos_index: [S_buf + 1]
    int64, the pos_emb row of each slot, -1 for slots outside the window;
    attn_mask: [B, S_buf + 1] additive. Returns (out [B, 1, D], k_new,
    v_new [B, H, 1, Dh] in x's dtype); the caller appends the new frame to
    the cache (quantizing it for an int8 cache).
    """
    B, T, D = x.shape
    if T != 1:
        raise NotImplementedError(
            "rel_pos_mha_fullbuf: only chunk_len 1 (right context 0) is "
            "ported so far")
    xt = x[:, 0]
    q = linear(xt, q_w).view(B, n_heads, d_head)
    k_new = linear(xt, k_w).view(B, n_heads, d_head)
    v_new = linear(xt, v_w).view(B, n_heads, d_head)
    pos = linear(pos_emb, pos_w).view(-1, n_heads, d_head)  # [pos_len, H, Dh]
    q_u = q + bias_u
    pos_raw = torch.einsum("bhd,phd->bhp", q + bias_v, pos)  # [B, H, pos_len]
    live = pos_index >= 0
    pos_sc = pos_raw[..., pos_index.clamp(min=0)] * live  # [B, H, S_buf + 1]
    scale = 1.0 / math.sqrt(d_head)
    pos_mask = pos_sc.float() * scale + attn_mask.float()[:, None, :]
    ctx = t1_attention_core(q_u, k_new, v_new, pos_mask, k_buf, v_buf)
    out = linear(ctx.to(x.dtype).reshape(B, 1, D), out_w)
    return out, k_new[:, :, None, :], v_new[:, :, None, :]
