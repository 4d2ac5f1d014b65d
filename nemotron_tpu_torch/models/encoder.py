"""FastConformer encoder (port of nemotron_tpu/models/encoder.py): the
cache-aware streaming step (its all-active and masked fast paths) and the
offline batch encoder `encode_batch` (full attention over each utterance
of a ragged, zero-padded batch; no caches).

The K/V caches are head-major [L, B, H, S_buf, Dh] phased slack buffers
(dense, or int8 `QuantKV` codes with per-frame scales [L, B, H, S_buf]):
the 70-frame history window of a stream sits at slots [phase*chunk_len,
phase*chunk_len + lc); each chunk appends its chunk_len new frames right
after the window and the caller moves to phase + 1; once every n_phases
chunks `compact_cache` moves the window back to phase 0. Conv caches are
[L, B, K-1, D]. chunk_len is 1, 2, 7 or 14 frames at right context 0, 1,
6 or 13; a chunk may be longer than the window (the window then holds the
last lc of the chunk's frames).

In-place updates: where the JAX package donates the cache buffers to XLA,
the port writes them in place — `stream_encode_step` appends the new K/V
frames into `k_cache`/`v_cache` and overwrites `conv_cache`;
`compact_cache` and `realign_cache` rewrite the buffers they are given,
row by masked row through ops/kv_rows.py (kernel `csrc/kv_rows.cu` on the
card: the slot mask is read on the device, so neither reads anything back
to the host and both run inside CUDA graphs). A caller that needs the old
state keeps its own copy.

`attn_block` (chunk_len 1) runs each layer's attention sub-block (LN,
projections, attention, out projection, residual) as one call of kernel B3
(ops/attn_block.py) instead of LN + `rel_pos_mha_fullbuf` (kernel B1): the
JAX package's NEMOTRON_TPU_PALLAS_ATTN_BLOCK path, taken as an argument. At
chunk_len > 1 the layers take `rel_pos_mha_fullbuf` whatever attn_block
says, as in the JAX package.

`tp` (a params.TPGroup, one dp shard of a mesh: parallel/mesh.py) runs the
layers Megatron-style over the shard's tp devices, as the JAX package's
GSPMD does from its shardings: each device computes its heads' attention
(against its HeadShards part of the caches, through B1 or B3) and its d_ff
slice of each FFN; the partial products of the out projection and of each
FFN's w2 are summed on the lead device (ops/basic.tp_sum), where the
residual is added once. LayerNorms, the conv module, the subsampling and
the prompt fusion run once, on the lead device. Everything a rank does
(its inputs' copies to its device, its heads, its FFN slice, its
partial's copy to the lead, every write to its HeadShards parts, the
slot operations' kv_rows launches on them) runs on that rank's stream
between a fork from and a join to the lead's current stream
(TPGroup.each, kvquant.on_parts), so a tp shard's call is captured as one
CUDA graph with a branch per rank (graphs.py), and its caches are written
in place, part by part.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attn_block import t1_attention_block
from ..ops.basic import ffn, glu, layer_norm, linear, tp_sum
from ..ops.conv import conv_subsampling, depthwise_causal_conv1d
from ..ops.kvquant import (HeadShards, is_quant, kv_cat, kv_parts, kv_slice,
                           kv_update_slice_, kv_where, on_parts, quantize_kv)
from ..ops.kv_rows import ROLL, SHIFT, caches_rows_
from ..ops.quant import is_quantized
from ..ops.rel_attention import (rel_pos_mha, rel_pos_mha_fullbuf,
                                 rel_pos_mha_window)
from ..params import layer_slice
from ..config import CacheConfig, Hparams


def conformer_layer(x, lp, hp: Hparams, attention, conv_cache=None,
                    ffns=None):
    """One conformer layer.

    x + .5*FFN1 -> +MHA -> +Conv -> +.5*FFN2 -> final LN. `attention` is
    the attention sub-block (LN + MHA + residual), a callable res ->
    (res', k_new, v_new): `attention_sublayer` of the streaming or the
    offline MHA, or one call of kernel B3. conv_cache [B, K-1, D] is the
    streaming conv's carried left context; None zero-pads (offline).
    `ffns` (the two FFNs as callables, `_tp_layer`'s) replaces lp's FFN
    matrices. Returns (y, k_new, v_new, conv_cache' [B, K-1, D]).
    """
    if ffns is None:
        ffns = (lambda cur: ffn(cur, lp.ffn1_w1, lp.ffn1_w2),
                lambda cur: ffn(cur, lp.ffn2_w1, lp.ffn2_w2))
    res = x
    cur = layer_norm(res, lp.norm_ff1_w, lp.norm_ff1_b)
    res = res + 0.5 * ffns[0](cur)
    res, k_new, v_new = attention(res)

    # conv module: LN -> pw1 -> GLU -> causal dw conv -> LN -> SiLU -> pw2
    cur = layer_norm(res, lp.norm_conv_w, lp.norm_conv_b)
    cur = glu(linear(cur, lp.conv_pw1_w))
    cur, conv_out = depthwise_causal_conv1d(cur, lp.conv_dw_w, conv_cache)
    cur = layer_norm(cur, lp.conv_ln_w, lp.conv_ln_b)
    cur = linear(F.silu(cur), lp.conv_pw2_w)
    res = res + cur

    cur = layer_norm(res, lp.norm_ff2_w, lp.norm_ff2_b)
    res = res + 0.5 * ffns[1](cur)
    y = layer_norm(res, lp.norm_final_w, lp.norm_final_b)
    return y, k_new, v_new, conv_out


def attention_sublayer(lp, mha):
    """LN + MHA + residual as conformer_layer's `attention`; mha: LN(res)
    -> (out, k_new, v_new)."""
    def call(res):
        out, k_new, v_new = mha(layer_norm(res, lp.norm_attn_w,
                                           lp.norm_attn_b))
        return res + out, k_new, v_new
    return call


def _attn_weights(lp):
    return (lp.attn_q_w, lp.attn_k_w, lp.attn_v_w, lp.attn_pos_w,
            lp.attn_out_w, lp.pos_bias_u, lp.pos_bias_v)


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


@functools.lru_cache(maxsize=None)  # kept: a captured tick holds them
def _phase_tensors(lc, chunk_len, s_buf, phase, device):
    j_of_s, pos_index = _phase_attn_constants(lc, chunk_len, s_buf, phase)
    return (torch.tensor(j_of_s, device=device),
            torch.tensor(pos_index, device=device))


ATTN_BLOCK_WEIGHTS = ("attn_q_w", "attn_k_w", "attn_v_w", "attn_out_w")


def check_attn_block_weights(layers) -> None:
    """Kernel B3 takes the four attention matrices dense, as the JAX
    package's Pallas block does; quantized ones are refused."""
    bad = [n for n in ATTN_BLOCK_WEIGHTS if is_quantized(getattr(layers, n))]
    if bad:
        raise ValueError(
            f"attn_block: the fused attention block (kernel B3) needs dense "
            f"attention weights, but {', '.join(bad)} are quantized; run "
            f"without attn_block (NEMOTRON_TPU_PALLAS_ATTN_BLOCK) or without "
            f"quantized weights")


def _block_call(lp, hp: Hparams, pos, pos_index, mask, k_buf, v_buf,
                n_heads: int | None = None, residual: bool = True):
    """Layer lp's attention sub-block as one B3 call: res -> (res', k_new,
    v_new [B, H, 1, Dh]). pos [pos_len, H * Dh] is pos_emb . attn_pos_w^T;
    pos_index is the one query's row [S_buf + 1]; pp is built here, outside
    the kernel as in the JAX package (encoder.py:345-350): pp[h, d, s] =
    pos[pos_index[s], h, d] on live slots, 0 on dead ones (the index form of
    its one-hot contraction). n_heads (default hp's) and residual=False
    give a tp shard's call: its heads, its partial product in place of
    res'."""
    n_heads = n_heads or hp.n_heads
    live = (pos_index >= 0).to(torch.float32)
    ph = pos.float().view(-1, n_heads, hp.d_head)
    pp = (ph[pos_index.clamp(min=0)] * live[:, None, None]).permute(
        1, 2, 0).contiguous()

    def call(res):
        out, kn, vn = t1_attention_block(
            res[:, 0], lp.norm_attn_w, lp.norm_attn_b, lp.attn_q_w,
            lp.attn_k_w, lp.attn_v_w, lp.attn_out_w, lp.pos_bias_u,
            lp.pos_bias_v, pp, mask, k_buf, v_buf, n_heads,
            hp.d_head, residual=residual)
        return out[:, None], kn[:, :, None], vn[:, :, None]

    return call


def _tp_layer(tp, layer: int, hp: Hparams, attend, fused_ln: bool = False):
    """Layer `layer` over a dp shard's tp devices (see the module
    docstring): (lead layer params, attention, ffns) for conformer_layer.
    attend(t, lp_t, cur_t) runs device t's heads on cur_t (LN(res) on
    device t; res itself with fused_ln, where the call does its own LN,
    as B3) and returns (partial, k_new, v_new); each rank runs on its own
    stream (TPGroup.each) and moves its partial to the lead there; the
    partials are summed on the lead device after the join and added to
    res once, and the new K/V frames come back as HeadShards (on the
    ranks' devices)."""
    lps = [layer_slice(p.layers, layer) for p in tp.params]
    lead = lps[0]

    def attention(res):
        cur = res if fused_ln else layer_norm(res, lead.norm_attn_w,
                                               lead.norm_attn_b)

        def rank(t):
            out, k_new, v_new = attend(t, lps[t], cur.to(tp.devices[t]))
            return out.to(res.device), k_new, v_new

        outs, ks, vs = zip(*tp.each(rank))
        return (res + tp_sum(outs, res.device), HeadShards(list(ks)),
                HeadShards(list(vs)))

    def mlp(which):
        def call(cur):
            return tp_sum(tp.each(lambda t: ffn(
                cur.to(tp.devices[t]), getattr(lps[t], f"ffn{which}_w1"),
                getattr(lps[t], f"ffn{which}_w2")).to(cur.device)),
                cur.device)
        return call

    return lead, attention, (mlp(1), mlp(2))


def _on_each(tp, *tensors):
    """`tensors` on each of the tp devices, [t] -> tuple (the same tensors
    on the lead device and wherever the devices coincide), each rank's
    copies made on its stream (TPGroup.each)."""
    return tp.each(lambda t: tuple(x.to(tp.devices[t]) for x in tensors))


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


def encode_batch(params, hp: Hparams, mel, prompt_onehot=None,
                 n_frames=None, n_mel_frames=None, tp=None):
    """Offline encoder (nemotron_tpu/models/encoder.py:encode_batch):
    mel [B, T, n_mels] -> [B, T', d_model], full attention over each
    utterance, T' = subsampled_len(T) <= hp.max_pos_len (the pos table).

    n_frames ([B], valid subsampled frames) masks the padded keys;
    n_mel_frames ([B], valid mel frames) masks each subsampling level at
    its exact-length width. With both, each row's valid prefix equals its
    exact-length run: every conv is causal, so the zero padding reaches no
    valid frame (a ragged batch, or a segment padded to its bucket).
    tp: the layers over a dp shard's tp devices (the module docstring).
    """
    x = conv_subsampling(params.subsampling, mel, n_frames=n_mel_frames)
    t = x.shape[1]
    pe = pos_emb_slice(params.pos_emb, 2 * t - 1)
    attn_mask = None
    if n_frames is not None:
        pos = torch.arange(t, device=x.device)
        attn_mask = torch.where(pos[None, :] >= n_frames[:, None].to(pos.dtype),
                                -1e9, 0.0).to(x.dtype)

    if tp is not None:
        per_dev = _on_each(tp, pe, *(() if attn_mask is None else (attn_mask,)))
        h_tp = hp.n_heads // len(tp.devices)

        def attend(t, lp, cur):
            pe_t, *m = per_dev[t]
            return rel_pos_mha(cur, pe_t, *_attn_weights(lp), h_tp,
                               hp.d_head, m[0] if m else None), None, None

    for layer in range(hp.n_layers):
        if tp is not None:
            lp, attention, ffns = _tp_layer(tp, layer, hp, attend)
            x = conformer_layer(x, lp, hp, attention, ffns=ffns)[0]
            continue
        lp = layer_slice(params.layers, layer)
        attention = attention_sublayer(
            lp, lambda cur, lp=lp: (rel_pos_mha(
                cur, pe, *_attn_weights(lp), hp.n_heads, hp.d_head,
                attn_mask), None, None))
        x = conformer_layer(x, lp, hp, attention)[0]
    if params.prompt is not None and prompt_onehot is not None:
        x = prompt_fusion(params.prompt, x, prompt_onehot)
    return x


def stream_encode_step(params, hp: Hparams, cfg: CacheConfig, mel_chunk,
                       k_cache, v_cache, conv_cache, cache_valid,
                       prompt_onehot=None, phase: int = 0, active_mask=None,
                       attn_block: bool = False, advance_phase: bool = True,
                       tp=None):
    """One streaming encoder chunk: the phased fast path, or with
    advance_phase=False the legacy phase-stationary step.

    mel_chunk: [B, chunk_mel_frames, n_mels]; k_cache/v_cache: [L, B, H,
    S_buf, Dh], dense or QuantKV (the new frames are quantized as they are
    written); conv_cache: [L, B, K-1, D]; cache_valid: [B] int32; phase:
    the slack-buffer phase in [0, n_phases). The chunk_len new frames are
    appended at slot phase*chunk_len + lc, IN PLACE, and conv_cache is
    overwritten in place; the caller then moves to phase + 1 and compacts
    at the wrap.

    active_mask ([B] bool, optional) is the masked fast path: inactive slots
    keep their append slot (int8 codes and scales), conv cache and
    cache_valid bit for bit; their
    windows stay where they were and the engine realigns them on resume.

    attn_block: at chunk_len 1, each layer's attention sub-block is one call
    of kernel B3. It takes dense attention weights only; api.ASRModel
    refuses quantized ones when it is built (check_attn_block_weights).

    advance_phase=False (the legacy gated tick, nemotron_tpu/models/
    encoder.py:444-453): the layers attend to the live window [phase *
    chunk_len, phase * chunk_len + lc) alone (`rel_pos_mha_window`, never
    B1 or B3), and the window is rewritten shifted in place at the SAME
    phase (its last lc frames after the new ones), so a paused slot's
    window never moves. With active_mask, inactive slots keep their window,
    conv cache and cache_valid: the JAX package gates the whole buffers
    after the step, and only the window differs between the two.

    tp: the layers over a dp shard's tp devices (the module docstring);
    k_cache / v_cache are then HeadShards over them.

    Returns (enc_out [B, chunk_len, D], k_cache, v_cache, conv_cache,
    cache_valid').
    """
    lc = cfg.att_left_context
    chunk_len = cfg.chunk_len(hp)
    x = conv_subsampling(params.subsampling, mel_chunk)
    x = x[:, cfg.drop_extra_pre_encoded:, :]
    pe = pos_emb_slice(params.pos_emb, 2 * (lc + chunk_len) - 1)
    am = None if active_mask is None else active_mask.to(torch.bool)
    if not advance_phase:
        x = _gated_layers(params, hp, x, pe, k_cache, v_cache, conv_cache,
                          cache_valid, am, phase * chunk_len, lc, tp)
    else:
        x = _phased_layers(params, hp, x, pe, k_cache, v_cache, conv_cache,
                           cache_valid, am, phase, lc, chunk_len,
                           attn_block, tp)
    if params.prompt is not None and prompt_onehot is not None:
        x = prompt_fusion(params.prompt, x, prompt_onehot)
    valid2 = torch.clamp(cache_valid + chunk_len, max=lc)
    if am is not None:
        valid2 = torch.where(am, valid2, cache_valid)
    return x, k_cache, v_cache, conv_cache, valid2


def _gated_layers(params, hp: Hparams, x, pe, k_cache, v_cache, conv_cache,
                  cache_valid, am, win_lo: int, lc: int, tp=None):
    """The layers of the legacy phase-stationary step (see
    stream_encode_step), the caches rewritten in place."""
    pos = torch.arange(lc + x.shape[1], device=x.device)
    mask = torch.where(pos[None, :] < (lc - cache_valid)[:, None], -1e9,
                       0.0).to(x.dtype)  # [B, lc + T]
    if tp is not None:
        per_dev = _on_each(tp, pe, mask)
        h_tp = hp.n_heads // len(tp.devices)
    for layer in range(hp.n_layers):
        kl, vl, cl = k_cache[layer], v_cache[layer], conv_cache[layer]
        kw = kv_slice(kl, win_lo, win_lo + lc, 2)
        vw = kv_slice(vl, win_lo, win_lo + lc, 2)
        ffns = None
        if tp is not None:
            lp, attention, ffns = _tp_layer(
                tp, layer, hp, lambda t, lpt, cur, kw=kw, vw=vw:
                rel_pos_mha_window(cur, per_dev[t][0], *_attn_weights(lpt),
                                   h_tp, hp.d_head, kw.parts[t], vw.parts[t],
                                   per_dev[t][1]))
        else:
            lp = layer_slice(params.layers, layer)
            attention = attention_sublayer(
                lp, lambda cur, lp=lp, kw=kw, vw=vw: rel_pos_mha_window(
                    cur, pe, *_attn_weights(lp), hp.n_heads, hp.d_head, kw,
                    vw, mask))
        x, k_new, v_new, cc2 = conformer_layer(x, lp, hp, attention, cl,
                                               ffns)

        def write(kl, vl, kw, vw, k_new, v_new):  # one device's buffers
            if is_quant(kl):
                k_new, v_new = quantize_kv(k_new), quantize_kv(v_new)
            # the window's last lc frames after the new ones (a copy: the
            # writes below overwrite the window it was read from)
            k_win = kv_cat([kw, k_new], 2)
            v_win = kv_cat([vw, v_new], 2)
            n = kv_parts(k_win)[0].shape[2]
            k_win = kv_slice(k_win, n - lc, n, 2)
            v_win = kv_slice(v_win, n - lc, n, 2)
            if am is not None:
                k_win = kv_where(am, k_win, kw, 0)
                v_win = kv_where(am, v_win, vw, 0)
            kv_update_slice_(kl, k_win, win_lo, 2)
            kv_update_slice_(vl, v_win, win_lo, 2)

        on_parts(tp, write, kl, vl, kw, vw, k_new, v_new)
        if am is not None:
            cc2 = torch.where(am[:, None, None], cc2, cl)
        cl.copy_(cc2)
    return x


def _phased_layers(params, hp: Hparams, x, pe, k_cache, v_cache, conv_cache,
                   cache_valid, am, phase: int, lc: int, chunk_len: int,
                   attn_block: bool, tp=None):
    """The layers of the phased fast path (see stream_encode_step), the new
    frames appended in place."""
    win_hi = phase * chunk_len + lc
    s_buf = kv_parts(k_cache)[0].shape[3]
    j_of_s, pos_index = _phase_tensors(lc, chunk_len, s_buf, phase, x.device)
    offset = lc - cache_valid  # [B]: slots with j < offset hold no history
    mask_full = torch.where(j_of_s[None, :] < offset[:, None], -1e9, 0.0
                            ).to(x.dtype)
    use_block = attn_block and chunk_len == 1
    if tp is not None:
        per_dev = _on_each(tp, pe, pos_index, mask_full)
        h_tp = hp.n_heads // len(tp.devices)

    for layer in range(hp.n_layers):
        kl, vl, cl = k_cache[layer], v_cache[layer], conv_cache[layer]
        ffns = None
        if tp is not None and use_block:
            def attend(t, lpt, res, kl=kl, vl=vl):
                pe_t, pi_t, m_t = per_dev[t]
                return _block_call(lpt, hp, linear(pe_t, lpt.attn_pos_w),
                                   pi_t[0], m_t, kl.parts[t], vl.parts[t],
                                   h_tp, residual=False)(res)
            lp, attention, ffns = _tp_layer(tp, layer, hp, attend,
                                            fused_ln=True)
        elif tp is not None:
            def attend(t, lpt, cur, kl=kl, vl=vl):
                pe_t, pi_t, m_t = per_dev[t]
                return rel_pos_mha_fullbuf(
                    cur, pe_t, *_attn_weights(lpt), h_tp, hp.d_head,
                    kl.parts[t], vl.parts[t], pi_t, m_t)
            lp, attention, ffns = _tp_layer(tp, layer, hp, attend)
        elif use_block:
            lp = layer_slice(params.layers, layer)
            attention = _block_call(lp, hp, linear(pe, lp.attn_pos_w),
                                    pos_index[0], mask_full, kl, vl)
        else:
            lp = layer_slice(params.layers, layer)
            attention = attention_sublayer(
                lp, lambda cur, lp=lp, kl=kl, vl=vl: rel_pos_mha_fullbuf(
                    cur, pe, *_attn_weights(lp), hp.n_heads, hp.d_head, kl,
                    vl, pos_index, mask_full))
        x, k_new, v_new, cc2 = conformer_layer(x, lp, hp, attention, cl,
                                               ffns)

        def write(kl, vl, k_new, v_new):  # one device's buffers
            if is_quant(kl):
                k_new, v_new = quantize_kv(k_new), quantize_kv(v_new)
            if am is not None:
                hi = win_hi + chunk_len
                k_new = kv_where(am, k_new, kv_slice(kl, win_hi, hi, 2), 0)
                v_new = kv_where(am, v_new, kv_slice(vl, win_hi, hi, 2), 0)
            kv_update_slice_(kl, k_new, win_hi, 2)
            kv_update_slice_(vl, v_new, win_hi, 2)

        on_parts(tp, write, kl, vl, k_new, v_new)
        if am is not None:
            cc2 = torch.where(am[:, None, None], cc2, cl)
        cl.copy_(cc2)
    return x


def _device_mask(mask):
    """A [B] slot mask as a bool tensor (None stays None)."""
    return None if mask is None else torch.as_tensor(mask).to(torch.bool)


def compact_cache(cfg: CacheConfig, hp: Hparams, k_cache, v_cache,
                  phase: int | None = None, mask=None, tp=None):
    """Move the live history window back to phase 0, in place.

    `phase` is the phase the caller is at (default n_phases, the wrap): the
    window sits at [phase*chunk_len, phase*chunk_len + lc). A mid-cycle
    compaction MUST pass its phase. `mask` ([B] bool) compacts only those
    slots; the others keep their windows untouched. One masked row rewrite
    per buffer (ops/kv_rows.py: on the card one kernel launch, the mask
    read on the device; no temporary). tp: HeadShards caches' parts each
    rewritten on its rank's stream (kvquant.on_parts)."""
    lc = cfg.att_left_context
    if phase is None:
        phase = cfg.n_phases
    lo = phase * cfg.chunk_len(hp)
    if lo == 0:
        return k_cache, v_cache
    caches_rows_(k_cache, v_cache, SHIFT, _device_mask(mask), tp, lo=lo,
                 lc=lc)
    return k_cache, v_cache


def realign_cache(cfg: CacheConfig, hp: Hparams, k_cache, v_cache,
                  delta: int, mask, tp=None):
    """Realign-on-resume, in place: roll the masked slots' S axis forward by
    `delta` phases so their window sits at the group's current phase. The
    wrapped-around region lies outside the live window and is never read.
    One masked row rewrite per buffer (ops/kv_rows.py); tp as in
    compact_cache."""
    if delta == 0:
        raise ValueError("realign_cache: delta must be non-zero")
    shift = delta * cfg.chunk_len(hp)
    caches_rows_(k_cache, v_cache, ROLL, _device_mask(mask), tp,
                 shift=shift)
    return k_cache, v_cache
