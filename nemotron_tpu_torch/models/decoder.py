"""RNNT prediction network + joint + batched greedy decode (port of the
loop-labels form of nemotron_tpu/models/decoder.py).

Semantics as the reference: <= MAX_SYMBOLS_PER_STEP (10) emissions per
encoder frame, argmax over all logits with the first maximum winning, LSTM
state and prev_token advance only on a non-blank emission, and a blank (or
the frame cap) moves a stream to its next frame.

The JAX loop exits once every stream has passed its n_valid frames
(`any(frame_idx < n_valid)`, decoder.py:219-222). In PyTorch that test is
a host sync, which no CUDA graph can hold. The streaming tick runs the
loop's fixed bound t*(s_max+1)+1 (`greedy_decode`). The offline path runs
the loop in blocks of a fixed number of iterations on a carry in fixed
storage (`DecodeCarry`, `decode_block`: the body of one graph per batch
size) and tests the exit on the host between blocks (models/asr.py). An
iteration in which no stream is active changes nothing, and past
t*(s_max+1)+1 iterations none is, so a block that runs past the exit, or
past the bound, gives the same tokens and state.

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
from ..utils.trace import Totals


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


def enc_projection(jp, enc):
    """The joint's encoder-side projection: enc [..., D] -> [..., J]."""
    return enc @ jp.enc_w.T + jp.enc_b


def joint_step(jp, enc_t, dec_out):
    """Single-frame joint: enc_t [B, D], dec_out [B, decoder_dim] -> [B, V]."""
    return joint_from_proj(jp, enc_projection(jp, enc_t), dec_out)


def joint_from_proj(jp, enc_proj, dec_out):
    """Joint with the encoder-side projection precomputed ([B, joint_dim])."""
    d = dec_out @ jp.dec_w.T + jp.dec_b
    h = torch.relu(enc_proj + d)
    return h @ jp.out_w.T + jp.out_b


def _iteration(params, hp: Hparams, enc_proj, rows, n_valid, h, c, prev,
               frame_idx, sym_idx, acc, confidence: bool):
    """One loop-labels iteration (decoder.py:229-260 of the JAX package):
    returns (h, c, prev, frame_idx, sym_idx) advanced; an emission is
    written into acc [B, T * S] (value + 1) in place. A stream past its
    n_valid frames changes nothing."""
    t = enc_proj.shape[1]
    s_max = MAX_SYMBOLS_PER_STEP
    active = frame_idx < n_valid
    enc_t = enc_proj[rows, frame_idx.clamp(max=t - 1).long()]  # [B, J]
    emb = params.decoder.embedding[prev.long()]
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
    return (torch.where(gate, h2, h), torch.where(gate, c2, c),
            torch.where(emit, tok, prev),
            frame_idx + advance.to(torch.int32),
            torch.where(advance, 0, sym_idx + emit.to(torch.int32)))


def greedy_decode(params, hp: Hparams, enc_out, state: DecodeState,
                  n_valid=None, confidence: bool = False):
    """Loop-labels greedy RNNT decode over the fixed bound t*(s_max+1)+1
    (the streaming tick's).

    enc_out: [B, T, D]; n_valid: [B] int — frames >= n_valid are skipped
    (the zero-padded final chunk, inactive slots). Returns (state', tokens
    [B, T, S] int32 with -1 = no emission); a token at [b, t, s] was emitted
    at absolute frame state.frame_offset[b] + t. confidence: the tokens
    carry packed confidences (see unpack_tokens).
    """
    b, t, _ = enc_out.shape
    dev = enc_out.device
    if n_valid is None:
        n_valid = torch.full((b,), t, dtype=torch.int32, device=dev)
    n_valid = n_valid.to(torch.int32)
    enc_proj = enc_projection(params.joint, enc_out)  # [B, T, J]
    rows = torch.arange(b, device=dev)
    loop = (state.h, state.c, state.prev_token,
            torch.zeros((b,), dtype=torch.int32, device=dev),
            torch.zeros((b,), dtype=torch.int32, device=dev))
    acc = torch.zeros((b, t * MAX_SYMBOLS_PER_STEP), dtype=torch.int32,
                      device=dev)
    for _ in range(t * (MAX_SYMBOLS_PER_STEP + 1) + 1):
        loop = _iteration(params, hp, enc_proj, rows, n_valid, *loop, acc,
                          confidence)
    h, c, prev = loop[:3]
    tokens = acc.view(b, t, MAX_SYMBOLS_PER_STEP) - 1  # 0 (never written) -> -1
    return DecodeState(h=h, c=c, prev_token=prev,
                       frame_offset=state.frame_offset + n_valid), tokens


# --- the offline decode in blocks ----------------------------------------


@dataclasses.dataclass
class DecodeCarry:
    """The offline decode's loop state in fixed storage, written in place
    (the offline graphs replay on its addresses; api.ASRModel keeps one
    per batch size). `enc_proj` holds the segment's encoder projection in
    its first T' frames; frames past T' are never read by an active
    stream."""
    enc_proj: torch.Tensor   # [B, T, J]
    n_valid: torch.Tensor    # [B] int32
    h: torch.Tensor          # [B, 2, decoder_dim]
    c: torch.Tensor          # [B, 2, decoder_dim]
    prev_token: torch.Tensor  # [B] int32
    frame_idx: torch.Tensor  # [B] int32
    sym_idx: torch.Tensor    # [B] int32
    acc: torch.Tensor        # [B, T * S] int32, emission + 1 (0: none)

    @property
    def frames(self) -> int:
        return self.enc_proj.shape[1]


def init_carry(batch: int, frames: int, hp: Hparams, dtype=torch.float32, *,
               device) -> DecodeCarry:
    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    shape = (batch, hp.decoder_layers, hp.decoder_dim)
    return DecodeCarry(
        enc_proj=torch.zeros((batch, frames, hp.joint_dim), dtype=dtype,
                             device=device),
        n_valid=i32(batch), h=torch.zeros(shape, dtype=dtype, device=device),
        c=torch.zeros(shape, dtype=dtype, device=device),
        prev_token=i32(batch), frame_idx=i32(batch), sym_idx=i32(batch),
        acc=i32(batch, frames * MAX_SYMBOLS_PER_STEP))


def start_carry(carry: DecodeCarry, state: DecodeState, n_valid) -> None:
    """A segment's start: the decoder state and n_valid copied in, the
    frame and symbol pointers and the emissions zeroed (in place)."""
    carry.n_valid.copy_(n_valid)
    carry.h.copy_(state.h)
    carry.c.copy_(state.c)
    carry.prev_token.copy_(state.prev_token)
    for t in (carry.frame_idx, carry.sym_idx, carry.acc):
        t.zero_()


def decode_block(params, hp: Hparams, carry: DecodeCarry, n_iter: int,
                 confidence: bool = False) -> tuple:
    """n_iter loop-labels iterations on the carry, written back into its
    storage (the body of the offline decode's graph; no outputs)."""
    b = carry.n_valid.shape[0]
    rows = torch.arange(b, device=carry.acc.device)
    loop = (carry.h, carry.c, carry.prev_token, carry.frame_idx,
            carry.sym_idx)
    for _ in range(n_iter):
        loop = _iteration(params, hp, carry.enc_proj, rows, carry.n_valid,
                          *loop, carry.acc, confidence)
    for dst, src in zip((carry.h, carry.c, carry.prev_token,
                         carry.frame_idx, carry.sym_idx), loop):
        dst.copy_(src)
    return ()


def decode_in_blocks(carry: DecodeCarry, t: int, most: int, block: int,
                     run_block, spans: Totals | None = None) -> int:
    """The offline decode's host loop over a segment of t frames:
    run_block() runs `block` iterations on the carry (decode_block, or its
    graph's replay). JAX's while-loop cond, any stream with a frame left
    (decoder.py:219), is read on the host after each block once the
    iterations reach `most` (max n_valid: no stream can be done sooner),
    so the blocks may run up to block - 1 iterations past the eager
    loop's stop, or past the bound t*(s_max+1)+1: those change nothing.
    Each host read of the exit is a span `offline.exit_test` of `spans`
    (a caller's utils/trace.Totals). Returns the iterations run, in whole
    blocks."""
    spans = spans or Totals()
    bound = t * (MAX_SYMBOLS_PER_STEP + 1) + 1
    it = 0
    while it < bound:
        if it >= most:
            with spans.span("offline.exit_test"):
                left = bool((carry.frame_idx < carry.n_valid).any())
            if not left:
                break
        run_block()
        it += block
    return it


def carry_result(carry: DecodeCarry, state: DecodeState, n_valid,
                 t: int) -> tuple:
    """(state', tokens [B, t, S]) of a decoded segment of t frames, copied
    out of the carry (the next segment's start overwrites it)."""
    b = carry.acc.shape[0]
    tokens = carry.acc.view(b, carry.frames, MAX_SYMBOLS_PER_STEP)[:, :t] - 1
    return DecodeState(h=carry.h.clone(), c=carry.c.clone(),
                       prev_token=carry.prev_token.clone(),
                       frame_offset=state.frame_offset + n_valid), tokens
