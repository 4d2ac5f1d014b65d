"""RNNT prediction network + joint + batched greedy decode (port of the
loop-labels form of nemotron_tpu/models/decoder.py).

Semantics as the reference: <= MAX_SYMBOLS_PER_STEP (10) emissions per
encoder frame, argmax over all logits with the first maximum winning, LSTM
state and prev_token advance only on a non-blank emission, and a blank (or
the frame cap) moves a stream to its next frame.

The JAX loop exits once every stream has passed its n_valid frames
(`any(frame_idx < n_valid)`, decoder.py:222). In eager PyTorch that test
is a host sync, so the streaming tick runs the loop's fixed bound
t*(s_max+1)+1 (a bound a CUDA graph of the tick can keep), and the offline
path (`exit_every`) tests it every few iterations, from the first one at
which every stream could be done (max n_valid): an iteration in which no
stream is active changes nothing, so both give the same tokens and state.

Per-token confidence: with `confidence=True` each emitted value carries a
7-bit quantized softmax probability of the chosen token, packed as
tok + vocab_size * q (q in 0..127), so the emission stays one int32 tensor;
-1 stays the no-emission sentinel and `unpack_tokens` splits the two. The
JAX package selects this with NEMOTRON_TPU_CONFIDENCE; the port takes the
argument.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.lstm import lstm2_step
from ..config import MAX_SYMBOLS_PER_STEP, Hparams


@dataclasses.dataclass
class DecodeState:
    h: torch.Tensor             # [B, 2, decoder_dim]
    c: torch.Tensor             # [B, 2, decoder_dim]
    prev_token: torch.Tensor    # [B] int32
    frame_offset: torch.Tensor  # [B] int32


def init_decode_state(batch: int, hp: Hparams, dtype=torch.float32, *,
                      device) -> DecodeState:
    shape = (batch, hp.decoder_layers, hp.decoder_dim)
    return DecodeState(
        h=torch.zeros(shape, dtype=dtype, device=device),
        c=torch.zeros(shape, dtype=dtype, device=device),
        prev_token=torch.full((batch,), hp.blank_id, dtype=torch.int32,
                              device=device),
        frame_offset=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def unpack_tokens(vals, vocab_size: int):
    """Packed emission values (a numpy array of any shape) -> (token ids,
    confidence in [0, 1]); the -1 sentinels pass through (confidence 0)."""
    emitted = vals >= 0
    ids = np.where(emitted, vals % vocab_size, vals)
    conf = np.where(emitted, (vals // vocab_size) / 127.0, 0.0)
    return ids, conf


def _pack_conf(tok, logits, vocab_size: int):
    """tok [B] int32 (the argmax of logits [B, V]) -> tok + V * q, q the
    chosen token's softmax probability in 1/127 steps (half to even)."""
    l32 = logits.float()
    m = l32.amax(dim=-1)
    p = 1.0 / torch.exp(l32 - m[:, None]).sum(-1)  # exp(m - logsumexp)
    q = torch.clamp(torch.round(p * 127.0), 0, 127).to(torch.int32)
    return tok + vocab_size * q


def joint_step(jp, enc_t, dec_out):
    """Single-frame joint: enc_t [B, D], dec_out [B, decoder_dim] -> [B, V]."""
    return joint_from_proj(jp, enc_t @ jp.enc_w.T + jp.enc_b, dec_out)


def joint_from_proj(jp, enc_proj, dec_out):
    """Joint with the encoder-side projection precomputed ([B, joint_dim])."""
    d = dec_out @ jp.dec_w.T + jp.dec_b
    h = torch.relu(enc_proj + d)
    return h @ jp.out_w.T + jp.out_b


def greedy_decode(params, hp: Hparams, enc_out, state: DecodeState,
                  n_valid=None, confidence: bool = False,
                  exit_every: int = 0, stats: dict | None = None):
    """Loop-labels greedy RNNT decode.

    enc_out: [B, T, D]; n_valid: [B] int — frames >= n_valid are skipped
    (the zero-padded final chunk, inactive slots). Returns (state', tokens
    [B, T, S] int32 with -1 = no emission); a token at [b, t, s] was emitted
    at absolute frame state.frame_offset[b] + t. confidence: the tokens
    carry packed confidences (see unpack_tokens).

    exit_every > 0 stops the loop once no stream has a frame left, tested
    on the host every exit_every iterations from iteration max(n_valid)
    on (one sync each); 0 runs the fixed bound t*(s_max+1)+1. stats (a
    dict), where given, gets the iterations run under "iterations".
    """
    b, t, _ = enc_out.shape
    dev = enc_out.device
    s_max = MAX_SYMBOLS_PER_STEP
    if n_valid is None:
        n_valid = torch.full((b,), t, dtype=torch.int32, device=dev)
    n_valid = n_valid.to(torch.int32)
    emb_table = params.decoder.embedding
    enc_proj = enc_out @ params.joint.enc_w.T + params.joint.enc_b  # [B,T,J]
    rows = torch.arange(b, device=dev)

    h, c, prev = state.h, state.c, state.prev_token
    frame_idx = torch.zeros((b,), dtype=torch.int32, device=dev)
    sym_idx = torch.zeros((b,), dtype=torch.int32, device=dev)
    acc = torch.zeros((b, t * s_max), dtype=torch.int32, device=dev)
    bound = t * (s_max + 1) + 1
    first_test = int(n_valid.max()) if exit_every and b else bound
    it = 0
    while it < bound:
        if it >= first_test and (it - first_test) % exit_every == 0 \
                and not bool((frame_idx < n_valid).any()):
            break
        it += 1
        active = frame_idx < n_valid
        enc_t = enc_proj[rows, frame_idx.clamp(max=t - 1).long()]  # [B, J]
        emb = emb_table[prev.long()]
        dec_out, h2, c2 = lstm2_step(params.decoder, emb, h, c)
        logits = joint_from_proj(params.joint, enc_t, dec_out)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)

        is_blank = tok == hp.blank_id
        forced = sym_idx >= s_max  # frame emission cap reached
        emit = active & ~is_blank & ~forced
        advance = active & (is_blank | forced)

        cell = (frame_idx.clamp(max=t - 1) * s_max
                + sym_idx.clamp(max=s_max - 1)).long()[:, None]
        val = _pack_conf(tok, logits, hp.vocab_size) if confidence else tok
        acc.scatter_(1, cell, torch.where(emit, val + 1,
                                          acc.gather(1, cell)[:, 0])[:, None])
        gate = emit[:, None, None]
        h = torch.where(gate, h2, h)
        c = torch.where(gate, c2, c)
        prev = torch.where(emit, tok, prev)
        frame_idx = frame_idx + advance.to(torch.int32)
        sym_idx = torch.where(advance, 0, sym_idx + emit.to(torch.int32))
    if stats is not None:
        stats["iterations"] = it
    tokens = acc.view(b, t, s_max) - 1  # 0 (never written) -> -1 sentinel
    new_state = DecodeState(h=h, c=c, prev_token=prev,
                            frame_offset=state.frame_offset + n_valid)
    return new_state, tokens
