"""The streaming steps (port of nemotron_tpu/models/asr.py: the fused path,
its masked and legacy gated forms, and `stream_step`).

`fused_serve_tick` advances a batch of streams by one chunk: int16 PCM ->
mel frontend (the mel kernel on the card) -> causal subsampling -> 24
cached conformer layers (the T=1 attention kernel B1 on the card, or the
fused attention block B3 with `attn_block`) -> greedy RNNT. `stream_step`
does the same from a mel chunk (the single-stream session computes its mel
on the host side). The caches are updated in place (see models/encoder.py).
`confidence` packs per-token confidences into the tokens
(models/decoder.py). Every step keeps the caller's storage: what the layers
do not update in place (the frontend carries, cache validity, the decoder
state) is written back into the caller's tensors at the end (state.
write_back), and the step returns the caller's state object, so a tick
body replays as a CUDA graph on fixed addresses (api.ASRModel).
`transcribe_batch` is the offline path: the batch encoder over whole
utterances, then the decode in blocks with its exit between them, each
part a body that api.ASRModel replays as a CUDA graph. `tp` (a
params.TPGroup) runs the encoder's layers over one dp shard's tp devices
(models/encoder.py); everything else runs on the lead device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import mel as melops
from ..config import CacheConfig, Hparams
from ..streaming.state import StreamState, write_back
from ..utils.trace import Totals
from .decoder import (DecodeCarry, carry_result, decode_block,
                      decode_in_blocks, enc_projection, greedy_decode,
                      init_carry, init_decode_state, start_carry,
                      unpack_tokens)
from .encoder import compact_cache, encode_batch, stream_encode_step


def _gate0(active, new, old):
    return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _prompt_onehot(params, prompt_idx, hp: Hparams):
    if params.prompt is None or prompt_idx is None:
        return None
    return torch.nn.functional.one_hot(
        prompt_idx.long(), hp.num_prompts).to(params.pos_emb.dtype)


def stream_step(params, state: StreamState, mel_chunk, n_valid, active,
                prompt_idx=None, *, hp: Hparams, cfg: CacheConfig,
                phase: int = 0, attn_block: bool = False,
                confidence: bool = False, tp=None):
    """Advance a batch of streams by one chunk of mel frames. The frontend
    carries are not touched.

    mel_chunk: [B, chunk_mel_frames, n_mels], cast to the activation type
    as the fused tick casts its mel; n_valid: [B] encoder frames to decode
    (fewer on the zero-padded final chunk). active None: every stream
    advances on the phased fast path (the caller advances the phase and
    compacts at the wrap). active [B] bool: the legacy gated step, phase-
    stationary (the caller keeps its phase), inactive slots keeping their
    state bit for bit (their n_valid is 0, so the decode leaves them too).
    Returns (state', tokens [B, chunk_len, S] int32, -1 = no emission).
    """
    act = None if active is None else active.to(torch.bool)
    n_valid = n_valid.to(torch.int32)
    if act is not None:
        n_valid = torch.where(act, n_valid, 0)
    enc, k2, v2, c2, valid2 = stream_encode_step(
        params, hp, cfg, mel_chunk.to(params.pos_emb.dtype), state.k_cache,
        state.v_cache, state.conv_cache, state.cache_valid,
        prompt_onehot=_prompt_onehot(params, prompt_idx, hp), phase=phase,
        active_mask=act, attn_block=attn_block, advance_phase=act is None,
        tp=tp)
    dec_state, tokens = greedy_decode(params, hp, enc, state.decode,
                                      n_valid=n_valid, confidence=confidence)
    return write_back(state, dataclasses.replace(
        state, k_cache=k2, v_cache=v2, conv_cache=c2, cache_valid=valid2,
        decode=dec_state)), tokens


def fused_encode_tick(params, state: StreamState, audio_block, active,
                      prompt_idx=None, *, hp: Hparams, cfg: CacheConfig,
                      phase: int = 0, fast_gated: bool = False,
                      attn_block: bool = False, tp=None):
    """Frontend + encoder half of the tick: raw PCM blocks in, encoder frames
    out, the frontend carries and caches advanced (decode state untouched).

    audio_block: [B, shift_samples] int16 (or f32 in [-1, 1]). active: None
    (all streams advance on the phased fast path) or [B] bool, where
    inactive slots keep every carry and cache bit for bit: with fast_gated
    the masked fast path (the engine realigns paused slots on resume),
    else the legacy gated step, phase-stationary (stream_encode_step's
    advance_phase=False).
    """
    x = audio_block.to(torch.float32)
    if not audio_block.is_floating_point():
        x = x / 32768.0
    window512 = melops.window512_of(params.preproc.window)
    fb = melops.filterbank_f32(params.preproc.filterbank)
    mel_new, tail2, last2 = melops.mel_step(
        x, state.pp_tail, state.pp_last, window512, fb,
        n_frames=cfg.shift_mel_frames)
    mel_chunk = torch.cat([state.mel_ov, mel_new], dim=1)
    new_ov = mel_chunk[:, cfg.shift_mel_frames:, :]

    act = None if active is None else active.to(torch.bool)
    enc, k2, v2, c2, valid2 = stream_encode_step(
        params, hp, cfg, mel_chunk.to(params.pos_emb.dtype),
        state.k_cache, state.v_cache, state.conv_cache, state.cache_valid,
        prompt_onehot=_prompt_onehot(params, prompt_idx, hp), phase=phase,
        active_mask=act, attn_block=attn_block,
        advance_phase=act is None or fast_gated, tp=tp)
    if act is not None:
        tail2 = _gate0(act, tail2, state.pp_tail)
        last2 = torch.where(act, last2, state.pp_last)
        new_ov = _gate0(act, new_ov, state.mel_ov)
    return write_back(state, dataclasses.replace(
        state, k_cache=k2, v_cache=v2, conv_cache=c2, cache_valid=valid2,
        pp_tail=tail2, pp_last=last2, mel_ov=new_ov)), enc


def decode_tick(params, state: StreamState, enc, n_valid, active=None, *,
                hp: Hparams, confidence: bool = False):
    """Greedy-RNNT half of the tick (inactive slots decode n_valid = 0)."""
    n_valid = n_valid.to(torch.int32)
    if active is not None:
        n_valid = torch.where(active.to(torch.bool), n_valid, 0)
    dec_state, tokens = greedy_decode(params, hp, enc, state.decode,
                                      n_valid=n_valid, confidence=confidence)
    return write_back(state, dataclasses.replace(state, decode=dec_state)), \
        tokens


def fused_serve_tick(params, state: StreamState, audio_block, n_valid, active,
                     prompt_idx=None, *, hp: Hparams, cfg: CacheConfig,
                     phase: int = 0, fast_gated: bool = False,
                     attn_block: bool = False, confidence: bool = False,
                     tp=None):
    """Whole serving step: raw PCM in -> tokens [B, chunk_len, S] out
    (fused_encode_tick, then decode_tick).

    Finalize: the host zero-pads the last partial block and passes the
    reduced n_valid; the junk mel frames of the padding lie past the last
    real frame, and the causal subsampling keeps them out of every valid
    output frame, so they never reach an emitted token.
    """
    state, enc = fused_encode_tick(params, state, audio_block, active,
                                   prompt_idx, hp=hp, cfg=cfg, phase=phase,
                                   fast_gated=fast_gated,
                                   attn_block=attn_block, tp=tp)
    return decode_tick(params, state, enc, n_valid, active, hp=hp,
                       confidence=confidence)


def fused_serve_tick_scan(params, state: StreamState, audio_blocks, n_valid,
                          prompt_idx=None, *, hp: Hparams, cfg: CacheConfig,
                          k: int, phase: int = 0, attn_block: bool = False,
                          confidence: bool = False, tp=None):
    """k all-active ticks in one call (backlog micro-batching), as a loop over
    chunks. Same contract as the JAX package: k | n_phases and phase % k == 0,
    so the slack-buffer wrap can only land after the last chunk.

    audio_blocks: [B, k * shift_samples]; returns tokens [B, k*chunk_len, S].
    """
    if cfg.n_phases % k or phase % k:
        raise ValueError(
            f"scan micro-batch needs k | n_phases and phase % k == 0 "
            f"(k={k}, phase={phase}, n_phases={cfg.n_phases})")
    shift = cfg.shift_samples
    toks = []
    for i in range(k):
        state, t = fused_serve_tick(
            params, state, audio_blocks[:, i * shift:(i + 1) * shift],
            n_valid, None, prompt_idx, hp=hp, cfg=cfg, phase=phase + i,
            attn_block=attn_block, confidence=confidence, tp=tp)
        toks.append(t)
    if phase + k == cfg.n_phases:  # wrap: move the window back to phase 0
        compact_cache(cfg, hp, state.k_cache, state.v_cache,
                      tp=tp)  # in place
    return state, torch.cat(toks, dim=1)


# the offline decode runs in graphed blocks of this many iterations, its
# exit tested on the host between blocks
DECODE_EXIT_EVERY = 16


def _eager(_key, body, state, inputs):
    return body(state, *inputs)


def offline_encode(params, carry: DecodeCarry, mel, n_frames=None,
                   n_mel_frames=None, prompt_idx=None, *, hp: Hparams,
                   tp=None) -> tuple:
    """The offline encoder's body (one graph per JAX key ("batch", T, B)):
    encode_batch, then the joint's encoder projection written into the
    carry's first T' frames. No outputs."""
    enc = encode_batch(params, hp, mel,
                       prompt_onehot=_prompt_onehot(params, prompt_idx, hp),
                       n_frames=n_frames, n_mel_frames=n_mel_frames, tp=tp)
    carry.enc_proj[:, :enc.shape[1]].copy_(enc_projection(params.joint, enc))
    return ()


def transcribe_batch(params, mel, *, hp: Hparams, prompt_idx=None,
                     n_frames=None, dec_state=None, n_mel_frames=None,
                     confidence: bool = False, stats: dict | None = None,
                     tp=None, carry: DecodeCarry | None = None, run=None,
                     spans: Totals | None = None):
    """Offline path (nemotron_tpu/models/asr.py:transcribe_batch): mel
    [B, T, n_mels] -> (tokens [B, T', S], dec_state'), the full-context
    encoder over each utterance, then the greedy decode with its exit.

    n_frames ([B] subsampled frames) and n_mel_frames ([B] mel frames)
    make a zero-padded ragged batch equal to exact-length runs (see
    encode_batch); dec_state carries the decoder across the segments of
    a long file.

    The segment is the encoder's body (offline_encode), then blocks of
    DECODE_EXIT_EVERY loop-labels iterations (decoder.decode_block), both
    on `carry` (decoder.init_carry of at least T' frames; made here at T'
    when None). `run(key, body, state, inputs)` runs each body under its
    key, the encoder's JAX key ("batch", T, B) and the decode block's
    ("batch_decode", B, carry frames, confidence) (api.ASRModel's graph
    cache); by default body(state, *inputs). The exit is tested on the
    host between blocks (decoder.decode_in_blocks). The encoder's call
    is a span `offline.encoder` of `spans` (a caller's utils/trace.Totals),
    the decode one `offline.decode`. stats, where given, gets the
    iterations run, in whole blocks, under "iterations", and the two
    spans' seconds under "encoder_seconds" and "decode_seconds".
    """
    b, t_mel = mel.shape[:2]
    t = hp.subsampled_len(t_mel)
    dev = mel.device
    dtype = params.pos_emb.dtype  # the activations'
    if carry is None:
        carry = init_carry(b, t, hp, dtype, device=dev)
    if dec_state is None:
        dec_state = init_decode_state(b, hp, dtype=dtype, device=dev)
    n_valid = (torch.full((b,), t, dtype=torch.int32, device=dev)
               if n_frames is None else n_frames.to(torch.int32))
    most = int(n_valid.max()) if b else 0
    run = run or _eager
    spans = spans or Totals()
    start_carry(carry, dec_state, n_valid)
    opt = {k: v for k, v in (("n_frames", n_frames),
                             ("n_mel_frames", n_mel_frames),
                             ("prompt_idx", prompt_idx)) if v is not None}

    def encode(c, x, *vals):
        return offline_encode(params, c, x, hp=hp, tp=tp,
                              **dict(zip(opt, vals)))

    def block(c):
        return decode_block(params, hp, c, DECODE_EXIT_EVERY, confidence)

    with spans.span("offline.encoder") as enc:
        run(("batch", t_mel, b), encode, carry, (mel, *opt.values()))
    key = ("batch_decode", b, carry.frames, confidence)
    with spans.span("offline.decode") as dec:
        it = decode_in_blocks(carry, t, most, DECODE_EXIT_EVERY,
                              lambda: run(key, block, carry, ()), spans)
    if stats is not None:
        stats.update(iterations=it, encoder_seconds=enc.seconds,
                     decode_seconds=dec.seconds)
    dec_state, tokens = carry_result(carry, dec_state, n_valid, t)
    return tokens, dec_state


def tokens_to_list(tokens, n_valid=None, vocab_size=None,
                   with_conf: bool = False):
    """Emission tensor -> per-stream ordered [(token_id, frame_idx), ...]
    (frame_idx relative to this chunk).

    vocab_size: the values carry packed confidences (a model built with
    confidence=True) and are unpacked with it; with_conf=True returns
    (token_id, frame_idx, conf | None) triples (None without vocab_size)."""
    arr = np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor)
                     else tokens)
    conf = None
    if vocab_size is not None:
        arr, conf = unpack_tokens(arr, vocab_size)
    out = []
    for b in range(arr.shape[0]):
        tmax = arr.shape[1] if n_valid is None else int(n_valid[b])
        seq = []
        for t in range(min(tmax, arr.shape[1])):
            for s in range(arr.shape[2]):
                tok = int(arr[b, t, s])
                if tok < 0:
                    continue
                if with_conf:
                    seq.append((tok, t, None if conf is None
                                else float(conf[b, t, s])))
                else:
                    seq.append((tok, t))
        out.append(seq)
    return out
