"""Cache-aware streaming FastConformer encoder (port of the all-active and
masked fast paths of nemotron_tpu/models/encoder.py).

The K/V caches are head-major [L, B, H, S_buf, Dh] phased slack buffers
(dense, or int8 `QuantKV` codes with per-frame scales [L, B, H, S_buf]):
the 70-frame history window of a stream sits at slots [phase*chunk_len,
phase*chunk_len + lc); each chunk appends its new frame right after the
window and the caller moves to phase + 1; once every n_phases chunks
`compact_cache` moves the window back to phase 0. Conv caches are
[L, B, K-1, D].

In-place updates: where the JAX package donates the cache buffers to XLA,
the port writes them in place — `stream_encode_step` appends the new K/V
frame into `k_cache`/`v_cache` and overwrites `conv_cache`;
`compact_cache` and `realign_cache` rewrite the buffers they are given.
A caller that needs the old state keeps its own copy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.basic import ffn, glu, layer_norm, linear
from ..ops.conv import conv_subsampling, depthwise_causal_conv1d
from ..ops.kvquant import (is_quant, kv_parts, kv_slice, kv_update_slice_,
                           kv_where, quantize_kv)
from ..ops.rel_attention import rel_pos_mha_fullbuf
from ..params import layer_slice
from ..shared.config import CacheConfig, Hparams


def conformer_layer(x, pos_emb, lp, hp: Hparams, k_buf, v_buf, conv_cache,
                    attn_mask, pos_index):
    """One cached conformer layer (full-slack-buffer attention).

    x + .5*FFN1 -> +MHA -> +Conv -> +.5*FFN2 -> final LN. Returns
    (y, k_new, v_new [B, H, T, Dh], conv_cache' [B, K-1, D]).
    """
    res = x
    cur = layer_norm(res, lp.norm_ff1_w, lp.norm_ff1_b)
    res = res + 0.5 * ffn(cur, lp.ffn1_w1, lp.ffn1_w2)

    cur = layer_norm(res, lp.norm_attn_w, lp.norm_attn_b)
    cur, k_new, v_new = rel_pos_mha_fullbuf(
        cur, pos_emb, lp.attn_q_w, lp.attn_k_w, lp.attn_v_w, lp.attn_pos_w,
        lp.attn_out_w, lp.pos_bias_u, lp.pos_bias_v, hp.n_heads, hp.d_head,
        k_buf, v_buf, pos_index, attn_mask)
    res = res + cur

    # conv module: LN -> pw1 -> GLU -> causal dw conv -> LN -> SiLU -> pw2
    cur = layer_norm(res, lp.norm_conv_w, lp.norm_conv_b)
    cur = glu(linear(cur, lp.conv_pw1_w))
    cur, conv_out = depthwise_causal_conv1d(cur, lp.conv_dw_w, conv_cache)
    cur = layer_norm(cur, lp.conv_ln_w, lp.conv_ln_b)
    cur = linear(F.silu(cur), lp.conv_pw2_w)
    res = res + cur

    cur = layer_norm(res, lp.norm_ff2_w, lp.norm_ff2_b)
    res = res + 0.5 * ffn(cur, lp.ffn2_w1, lp.ffn2_w2)
    y = layer_norm(res, lp.norm_final_w, lp.norm_final_b)
    return y, k_new, v_new, conv_out


@functools.lru_cache(maxsize=None)
def _phase_attn_constants(lc: int, chunk_len: int, s_buf: int, phase: int):
    """Phase constants (numpy) for full-buffer attention.

    Returns (j_of_s [S_buf + T] int32, pos_index [T, S_buf + T] int64):
    j_of_s maps each buffer slot (plus the T new frames) to its relative key
    index in the live window [phase*chunk_len, phase*chunk_len + lc), -1
    outside it — as nemotron_tpu/models/encoder.py; pos_index[t, s] is the
    pos_emb row the rel-shift reads for query t and slot s (j + T - 1 - t),
    -1 for dead slots: the index form of the JAX package's one-hot."""
    T = chunk_len
    lo = phase * chunk_len
    j_of_s = np.full((s_buf + T,), -1, dtype=np.int32)
    j_of_s[lo:lo + lc] = np.arange(lc, dtype=np.int32)
    j_of_s[s_buf:] = lc + np.arange(T, dtype=np.int32)
    t = np.arange(T)[:, None]
    pos_index = np.where(j_of_s[None, :] >= 0, j_of_s[None, :] + T - 1 - t, -1)
    return j_of_s, pos_index.astype(np.int64)


@functools.lru_cache(maxsize=256)
def _phase_tensors(lc, chunk_len, s_buf, phase, device):
    j_of_s, pos_index = _phase_attn_constants(lc, chunk_len, s_buf, phase)
    return (torch.tensor(j_of_s, device=device),
            torch.tensor(pos_index[0], device=device))


def pos_emb_slice(pos_table, pos_len: int):
    """Centred slice of the precomputed table."""
    off = (pos_table.shape[0] - pos_len) // 2
    return pos_table[off:off + pos_len]


def prompt_fusion(pk, enc, prompt_onehot):
    """Language-ID fusion. enc [B, T, D], prompt_onehot [B, num_prompts]."""
    b, t, _ = enc.shape
    oh = prompt_onehot[:, None, :].expand(b, t, prompt_onehot.shape[-1])
    h = torch.relu(linear(torch.cat([enc, oh.to(enc.dtype)], dim=-1),
                          pk.fc1_w, pk.fc1_b))
    return linear(h, pk.fc2_w, pk.fc2_b)


def stream_encode_step(params, hp: Hparams, cfg: CacheConfig, mel_chunk,
                       k_cache, v_cache, conv_cache, cache_valid,
                       prompt_onehot=None, phase: int = 0, active_mask=None):
    """One streaming encoder chunk on the phased fast path.

    mel_chunk: [B, chunk_mel_frames, n_mels]; k_cache/v_cache: [L, B, H,
    S_buf, Dh], dense or QuantKV (the new frames are quantized as they are
    written); conv_cache: [L, B, K-1, D]; cache_valid: [B] int32; phase:
    the slack-buffer phase in [0, n_phases). The new frame is appended at
    slot phase*chunk_len + lc, IN PLACE, and conv_cache is overwritten in
    place; the caller then moves to phase + 1 and compacts at the wrap.

    active_mask ([B] bool, optional) is the masked fast path: inactive slots
    keep their append slot (int8 codes and scales), conv cache and
    cache_valid bit for bit; their
    windows stay where they were and the engine realigns them on resume.

    Returns (enc_out [B, chunk_len, D], k_cache, v_cache, conv_cache,
    cache_valid').
    """
    lc = cfg.att_left_context
    chunk_len = cfg.chunk_len(hp)
    win_hi = phase * chunk_len + lc

    x = conv_subsampling(params.subsampling, mel_chunk)
    x = x[:, cfg.drop_extra_pre_encoded:, :]
    pe = pos_emb_slice(params.pos_emb, 2 * (lc + chunk_len) - 1)

    s_buf = kv_parts(k_cache)[0].shape[3]
    j_of_s, pos_index = _phase_tensors(lc, chunk_len, s_buf, phase, x.device)
    offset = lc - cache_valid  # [B]: slots with j < offset hold no history
    mask_full = torch.where(j_of_s[None, :] < offset[:, None], -1e9, 0.0
                            ).to(x.dtype)
    am = None if active_mask is None else active_mask.to(torch.bool)

    for layer in range(hp.n_layers):
        lp = layer_slice(params.layers, layer)
        kl, vl, cl = k_cache[layer], v_cache[layer], conv_cache[layer]
        x, k_new, v_new, cc2 = conformer_layer(
            x, pe, lp, hp, kl, vl, cl, mask_full, pos_index)
        if is_quant(kl):
            k_new, v_new = quantize_kv(k_new), quantize_kv(v_new)
        if am is not None:
            hi = win_hi + chunk_len
            k_new = kv_where(am, k_new, kv_slice(kl, win_hi, hi, 2), 0)
            v_new = kv_where(am, v_new, kv_slice(vl, win_hi, hi, 2), 0)
            cc2 = torch.where(am[:, None, None], cc2, cl)
        kv_update_slice_(kl, k_new, win_hi, 2)
        kv_update_slice_(vl, v_new, win_hi, 2)
        cl.copy_(cc2)

    if params.prompt is not None and prompt_onehot is not None:
        x = prompt_fusion(params.prompt, x, prompt_onehot)
    valid2 = torch.clamp(cache_valid + chunk_len, max=lc)
    if am is not None:
        valid2 = torch.where(am, valid2, cache_valid)
    return x, k_cache, v_cache, conv_cache, valid2


def _rows(mask):
    return None if mask is None else torch.nonzero(mask.to(torch.bool)).flatten()


def compact_cache(cfg: CacheConfig, hp: Hparams, k_cache, v_cache,
                  phase: int | None = None, mask=None):
    """Move the live history window back to phase 0, in place.

    `phase` is the phase the caller is at (default n_phases, the wrap): the
    window sits at [phase*chunk_len, phase*chunk_len + lc). A mid-cycle
    compaction MUST pass its phase. `mask` ([B] bool) compacts only those
    slots; the others keep their windows untouched."""
    lc = cfg.att_left_context
    if phase is None:
        phase = cfg.n_phases
    lo = phase * cfg.chunk_len(hp)
    if lo == 0:
        return k_cache, v_cache
    rows = _rows(mask)
    for buf in (*kv_parts(k_cache), *kv_parts(v_cache)):  # q and s alike
        if rows is None:
            buf[:, :, :, :lc] = buf[:, :, :, lo:lo + lc].clone()
        else:
            sel = buf[:, rows]  # [L, n, H, S(, Dh)] copy
            sel[:, :, :, :lc] = sel[:, :, :, lo:lo + lc].clone()
            buf[:, rows] = sel
    return k_cache, v_cache


def realign_cache(cfg: CacheConfig, hp: Hparams, k_cache, v_cache,
                  delta: int, mask):
    """Realign-on-resume, in place: roll the masked slots' S axis forward by
    `delta` phases so their window sits at the group's current phase. The
    wrapped-around region lies outside the live window and is never read."""
    if delta == 0:
        raise ValueError("realign_cache: delta must be non-zero")
    shift = delta * cfg.chunk_len(hp)
    rows = _rows(mask)
    for buf in (*kv_parts(k_cache), *kv_parts(v_cache)):
        buf[:, rows] = torch.roll(buf[:, rows], shift, dims=3)
    return k_cache, v_cache
