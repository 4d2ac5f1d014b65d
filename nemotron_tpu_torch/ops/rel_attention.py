"""Relative-position multi-head attention: streaming over the phased slack
buffer (port of nemotron_tpu/ops/rel_attention.py:rel_pos_mha_fullbuf),
streaming over the live window alone (`rel_pos_mha_window`, the legacy
gated tick's form) and offline over a whole utterance (`rel_pos_mha`, its
no-cache batch form).

Scores are computed against ALL S_buf cache slots plus the T new frames;
the phase's (query, slot) -> relative-position map arrives as `pos_index`
(an index gather in place of the JAX package's one-hot contraction: the
same values) and the window/validity selection as the additive
`attn_mask` (-1e9 on dead slots, whose softmax weight is exactly 0).

At T=1 (right context 0) the attention runs in kernel B1 with an f32
softmax, as the JAX package's Pallas path. At T>1 (right contexts 1, 6
and 13) the JAX package computes it as einsums outside any Pallas kernel,
in the activation type throughout (the 1/sqrt(Dh) scale and the softmax
included), and so does the port, with torch.matmul. The legacy gated
tick's window form is torch.matmul too: at T=1 in f32 (the JAX package's
default T=1 form), at T>1 in the activation type. The offline form is
the same einsums in the JAX package and torch.matmul here; its rel-shift
(`rel_shift_gather`) is a strided view of the position scores.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .attn_kernel import t1_attention_core
from .basic import linear
from .kvquant import is_quant, kv_parts


def rel_pos_mha_fullbuf(x, pos_emb, q_w, k_w, v_w, pos_w, out_w, bias_u,
                        bias_v, n_heads: int, d_head: int, k_buf, v_buf,
                        pos_index, attn_mask):
    """Streaming rel-pos MHA for a chunk of T new frames.

    x: [B, T, D]; pos_emb: [pos_len, D]; k_buf/v_buf: [B, H, S_buf, Dh]
    head-major per-layer cache views (read only), dense or int8 QuantKV;
    the weights are dense or quantized (ops/basic.linear); pos_index:
    [T, S_buf + T] int64, the pos_emb row query t reads for each slot, -1
    for slots outside the window; attn_mask: [B, S_buf + T] additive.
    Returns (out [B, T, D], k_new, v_new [B, H, T, Dh] in x's dtype); the
    caller appends the new frames to the cache (quantizing them for an int8
    cache).
    """
    B, T, D = x.shape
    if T == 1:
        return _mha_t1(x, pos_emb, q_w, k_w, v_w, pos_w, out_w, bias_u,
                       bias_v, n_heads, d_head, k_buf, v_buf, pos_index[0],
                       attn_mask)
    return _mha_matmul(x, pos_emb, q_w, k_w, v_w, pos_w, out_w, bias_u,
                       bias_v, n_heads, d_head, k_buf, v_buf, pos_index,
                       attn_mask, f32_softmax=False)


@functools.lru_cache(maxsize=None)  # kept: a captured tick holds them
def _window_pos_index(T: int, klen: int, device) -> torch.Tensor:
    """pos_index of a [window || new frames] key axis: query t reads row
    s + T - 1 - t for key s (the rel-shift, rel_shift_gather's values)."""
    s = np.arange(klen)[None, :] - np.arange(T)[:, None] + (T - 1)
    return torch.tensor(s, dtype=torch.int64, device=device)


def rel_pos_mha_window(x, pos_emb, q_w, k_w, v_w, pos_w, out_w, bias_u,
                       bias_v, n_heads: int, d_head: int, k_win, v_win,
                       attn_mask):
    """Streaming rel-pos MHA against the live window alone (the legacy
    gated tick's attention; nemotron_tpu/ops/rel_attention.py:rel_pos_mha
    with split_kv): k_win/v_win [B, H, lc, Dh] (dense or int8 QuantKV
    views, read only), attn_mask [B, lc + T] additive, pos_emb [2(lc + T)
    - 1, D]. At T=1 the scores, the softmax and the context run in f32 (the
    JAX package's default T=1 form, T1_VPU_ATTN, whose scale is still the
    activation type's 1/sqrt(Dh)); at T>1 in the activation type, as its
    einsums. Returns (out [B, T, D], k_new, v_new [B, H, T, Dh])."""
    T = x.shape[1]
    klen = kv_parts(k_win)[0].shape[2] + T
    return _mha_matmul(x, pos_emb, q_w, k_w, v_w, pos_w, out_w, bias_u,
                       bias_v, n_heads, d_head, k_win, v_win,
                       _window_pos_index(T, klen, x.device), attn_mask,
                       f32_softmax=T == 1)


def _mha_matmul(x, pos_emb, q_w, k_w, v_w, pos_w, out_w, bias_u, bias_v,
                n_heads, d_head, k_buf, v_buf, pos_index, attn_mask,
                f32_softmax: bool):
    """The attention as torch.matmul over a cache [B, H, S, Dh] plus the T
    new frames; pos_index [T, S + T] (-1 on dead slots). The content and
    context products, the softmax and the context run in f32 with
    f32_softmax, else in the activation type."""
    B, T, D = x.shape
    ct = torch.float32 if f32_softmax else x.dtype  # compute type
    q = linear(x, q_w).view(B, T, n_heads, d_head)
    k_new = linear(x, k_w).view(B, T, n_heads, d_head).transpose(1, 2)
    v_new = linear(x, v_w).view(B, T, n_heads, d_head).transpose(1, 2)
    pos = linear(pos_emb, pos_w).view(-1, n_heads, d_head)  # [pos_len, H, Dh]
    q_u = (q + bias_u).transpose(1, 2).to(ct)  # [B, H, T, Dh]
    # 1/sqrt(Dh) in the activation type, as JAX's asarray(d_head, x.dtype)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d_head), dtype=x.dtype))
    pos_raw = torch.einsum("bthd,phd->bhtp", q + bias_v, pos)
    live = pos_index >= 0
    rows = torch.arange(T, device=x.device)[:, None]
    pos_sc = pos_raw[:, :, rows, pos_index.clamp(min=0)] * live
    if is_quant(k_buf):
        # the int8 codes in the compute type, the per-frame scale folded
        # onto the scores after the Dh reduction
        c_hist = torch.matmul(q_u, k_buf.q.to(ct).transpose(-1, -2)) \
            * k_buf.s[:, :, None, :].to(ct)
    else:
        c_hist = torch.matmul(q_u, k_buf.to(ct).transpose(-1, -2))
    content = torch.cat(
        [c_hist, torch.matmul(q_u, k_new.to(ct).transpose(-1, -2))], dim=-1)
    scores = (content + pos_sc) * scale + attn_mask[:, None, None, :]
    weights = torch.softmax(scores, dim=-1)  # [B, H, T, S + T]
    s_buf = c_hist.shape[-1]
    if is_quant(v_buf):  # the scale folded onto the weights
        w_hist = weights[..., :s_buf] * v_buf.s[:, :, None, :].to(ct)
        ctx = torch.matmul(w_hist, v_buf.q.to(ct))
    else:
        ctx = torch.matmul(weights[..., :s_buf], v_buf.to(ct))
    ctx = ctx + torch.matmul(weights[..., s_buf:], v_new.to(ct))
    out = linear(ctx.to(x.dtype).transpose(1, 2).reshape(
        B, T, n_heads * d_head), out_w)
    return out, k_new, v_new


def _mha_t1(x, pos_emb, q_w, k_w, v_w, pos_w, out_w, bias_u, bias_v,
            n_heads, d_head, k_buf, v_buf, pos_index, attn_mask):
    """T=1 through kernel B1; pos_index is the query's row [S_buf + 1]."""
    B, _, D = x.shape
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
    out = linear(ctx.to(x.dtype).reshape(B, 1, n_heads * d_head), out_w)
    return out, k_new[:, :, None, :], v_new[:, :, None, :]


def rel_shift_gather(pos_raw, klen: int):
    """pos_raw [..., qlen, pos_len] -> [..., qlen, klen] with
    out[..., i, j] = pos_raw[..., i, j + qlen - 1 - i] (pos_len = 2 klen - 1,
    qlen <= klen), as a strided view of pos_raw: row i starts at i x
    (pos_len - 1) + qlen - 1 of the flat rows, so the shift moves no data
    (the values of the JAX package's one-hot product and pad-reshape
    trick, rel_attention.py:87-117)."""
    pos_raw = pos_raw.contiguous()
    *lead, qlen, pos_len = pos_raw.shape
    if qlen > klen or pos_len < klen + qlen - 1:
        raise ValueError(f"rel_shift_gather: qlen {qlen}, pos_len {pos_len} "
                         f"do not cover klen {klen}")
    stride = list(pos_raw.stride())
    return pos_raw.as_strided(
        (*lead, qlen, klen), (*stride[:-2], pos_len - 1, 1),
        pos_raw.storage_offset() + qlen - 1)


def rel_pos_mha(x, pos_emb, q_w, k_w, v_w, pos_w, out_w, bias_u, bias_v,
                n_heads: int, d_head: int, attn_mask=None):
    """Rel-pos MHA over a whole batch of utterances, no cache (the offline
    encoder; nemotron_tpu/ops/rel_attention.py:rel_pos_mha without caches).

    x: [B, T, D]; pos_emb: [2T - 1, D] (descending NeMo order);
    attn_mask: [B, T] additive (0 valid, -1e9 padded keys) or None. The
    scale and the softmax stay in the activation type, as the JAX
    package's einsums. Returns out [B, T, D].
    """
    B, T, D = x.shape
    q = linear(x, q_w).view(B, T, n_heads, d_head)
    k = linear(x, k_w).view(B, T, n_heads, d_head).transpose(1, 2)
    v = linear(x, v_w).view(B, T, n_heads, d_head).transpose(1, 2)
    pos = linear(pos_emb, pos_w).view(-1, n_heads, d_head)  # [2T-1, H, Dh]
    scale = 1.0 / torch.sqrt(torch.tensor(float(d_head), dtype=x.dtype))
    content = torch.matmul((q + bias_u).transpose(1, 2), k.transpose(-1, -2))
    pos_raw = torch.einsum("bthd,phd->bhtp", q + bias_v, pos)
    scores = (content + rel_shift_gather(pos_raw, T)) * scale
    del content, pos_raw
    if attn_mask is not None:
        scores = scores + attn_mask[:, None, None, :]
    weights = torch.softmax(scores, dim=-1)  # [B, H, T, T]
    del scores
    ctx = torch.matmul(weights, v)  # [B, H, T, Dh]
    return linear(ctx.transpose(1, 2).reshape(B, T, n_heads * d_head),
                  out_w)
