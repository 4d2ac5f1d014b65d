"""The plain reference that decides a run's `correct`:
nemotron-speech-streaming (cache-aware FastConformer + RNN-T) written out
plainly in float32 PyTorch (TF32 off, no kernels, no caches, no batching
across streams), after the published model and the reference engine's
equations (m1el/nemotron-asr.cpp: preprocessor.cpp, nemo-ggml.cpp,
nemo-stream.h). It imports nothing of the program under test and takes
only what the benchmark made (the weights, the audio) and what the program
served (its tokens and their frames), which it judges.

- mel: pre-emphasis 0.97, a 400-sample Hann window centred in a 512-point
  frame, hop 160, centre padding with zeros, power spectrum, the
  filterbank, log with a 2^-24 guard. A stream yields only the frames whose
  512 samples it has sent, so a stream of N samples has
  (N + 256 - 512) // 160 + 1 frames.
- subsampling: three causal stride-2 3x3 convolutions (the second and
  third depthwise, each followed by a pointwise one), ReLU, flattened
  channel-major, one linear.
- conformer layer: x + FFN1/2, + rel-pos MHA, + conv module (LN, pointwise,
  GLU, causal depthwise, LN, SiLU, pointwise), + FFN2/2, LN.
- streaming: cache-aware chunked streaming over causal convolutions equals
  one pass over the whole stream whose attention is banded per chunk (a
  query in chunk c sees [c * chunk - left context, (c + 1) * chunk)); the
  subsampled stream is the causal subsampling of [9 zero mel frames | mel]
  with its first 2 frames dropped.
- offline: each segment of at most `max_seg_mel_frames` mel frames is
  encoded alone with full attention; the decoder state runs on across
  segments.
- RNN-T: a two-layer LSTM prediction net fed the previous token (blank at
  the start), advanced only on a token; joint relu(enc_proj + dec_proj)
  -> logits; at most 10 tokens a frame, a blank ends the frame.

`decisions` lists every decision the program made (each token, and each
blank that ended a frame) from what it served, and `joint_logits` gives
the reference's logits there, the prediction net following the served
tokens (`prediction_outputs`); decoding.py hands them to judge.py, which
reads the gaps. A weight dict that
carries "_round" rounds both operands of every matmul and convolution
with it: a lower-precision copy of the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

MAX_SYMBOLS = 10
HOP = 160
N_FFT = 512


def _f32(t):
    return t.to(torch.float32)


def _mm(w, a, b):
    """a @ b, each operand first rounded by w's "_round" where the dict
    carries one (a lower-precision copy of the reference, judge.py)."""
    r = w.get("_round")
    return a @ b if r is None else r(a) @ r(b)


def _conv(w, fn, x, weight, *args, **kw):
    r = w.get("_round")
    return fn(x, weight, *args, **kw) if r is None else fn(r(x), r(weight),
                                                          *args, **kw)


def mel_frames_available(n_samples: int) -> int:
    """Mel frames a stream of n_samples has sent in full."""
    avail = N_FFT // 2 + n_samples
    return 0 if avail < N_FFT else (avail - N_FFT + HOP) // HOP


def log_mel(audio_i16: torch.Tensor, filterbank, window400) -> torch.Tensor:
    """int16 samples [N] -> [frames, n_mels] float32 (every frame whose
    samples the stream holds)."""
    n = int(audio_i16.shape[0])
    frames = mel_frames_available(n)
    x = audio_i16.to(torch.float32) / 32768.0
    y = torch.cat([x[:1], x[1:] - 0.97 * x[:-1]])
    spec = torch.stft(y, N_FFT, hop_length=HOP, win_length=window400.shape[0],
                      window=_f32(window400), center=True,
                      pad_mode="constant", return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2                 # [257, frames']
    mel = _f32(filterbank) @ power
    return torch.log(mel + 2.0 ** -24).T[:frames].contiguous()


def subsample(w, mel: torch.Tensor) -> torch.Tensor:
    """mel [T, n_mels] -> [T', d_model], causal (pad k-1 before, s-1
    after, on both axes)."""
    def pad(x):
        return F.pad(x, (2, 1, 2, 1))

    def conv(x, name, **kw):
        return _conv(w, F.conv2d, x, _f32(w[f"sub.{name}_w"]),
                     _f32(w[f"sub.{name}_b"]), **kw)

    c = w["sub.conv0_w"].shape[0]
    x = mel[None, None]
    x = F.relu(conv(pad(x), "conv0", stride=2))
    x = conv(pad(x), "conv2", stride=2, groups=c)
    x = F.relu(conv(x, "conv3"))
    x = conv(pad(x), "conv5", stride=2, groups=c)
    x = F.relu(conv(x, "conv6"))
    _, ch, t, f = x.shape
    flat = x[0].permute(1, 0, 2).reshape(t, ch * f)
    return _mm(w, flat, _f32(w["sub.out_w"]).T) + _f32(w["sub.out_b"])


def layer_weight(w, name: str, i: int) -> torch.Tensor:
    """Layer i's matrix `name` in float32: a dense weight upcast, or a Q8_0
    one ({"codes": int8 [L, out, in], "scales": [L, out, in / 32]})
    dequantized: codes x their block's scale."""
    v = w["layers." + name]
    if isinstance(v, dict):
        scales = _f32(v["scales"][i]).repeat_interleave(32, dim=-1)
        return v["codes"][i].to(torch.float32) * scales
    return _f32(v[i])


def _ln(x, w, name, i):
    return F.layer_norm(x, (x.shape[-1],), layer_weight(w, name + "_w", i),
                        layer_weight(w, name + "_b", i), eps=1e-5)


def _rel_pos_rows(pos_table, lo: int, hi: int) -> torch.Tensor:
    """Rows of the descending sinusoid table for relative positions hi,
    hi - 1, ..., lo: [hi - lo + 1, D]."""
    mid = (pos_table.shape[0] - 1) // 2
    return _f32(pos_table[mid - hi:mid - lo + 1])


def attention(w, i: int, x, pos_rows, rel_hi: int, n_heads: int,
              allowed=None):
    """Rel-pos MHA of layer i over x [T, D]; pos_rows: the rows for
    relative positions rel_hi, rel_hi - 1, ... (row p: rel_hi - p), covering
    every (query, key) pair that `allowed` (bool [T, T], or None: all)
    lets through."""
    t, d = x.shape
    dh = d // n_heads
    def proj(inp, name):
        return _mm(w, inp, layer_weight(w, name, i).T).view(-1, n_heads, dh)

    q, k, v = (proj(x, "attn_q_w"), proj(x, "attn_k_w"), proj(x, "attn_v_w"))
    p = proj(pos_rows, "attn_pos_w")
    qu = (q + layer_weight(w, "pos_bias_u", i)).transpose(0, 1)  # [H, T, dh]
    qv = (q + layer_weight(w, "pos_bias_v", i)).transpose(0, 1)
    ac = _mm(w, qu, k.permute(1, 2, 0))                          # [H, T, T]
    bd_raw = _mm(w, qv, p.permute(1, 2, 0))                      # [H, T, P]
    # key j of query i has relative position i - j: row rel_hi - (i - j);
    # pairs outside the rows are masked out below
    qi = torch.arange(t, device=x.device)[:, None]
    kj = torch.arange(t, device=x.device)[None, :]
    row = (rel_hi - qi + kj).clamp(0, p.shape[0] - 1)
    bd = torch.gather(bd_raw, 2, row.expand(n_heads, t, t))
    scores = (ac + bd) / math.sqrt(dh)
    if allowed is not None:
        scores = scores.masked_fill(~allowed, float("-inf"))
    ctx = _mm(w, torch.softmax(scores, dim=-1), v.transpose(0, 1))
    return _mm(w, ctx.transpose(0, 1).reshape(t, d),
               layer_weight(w, "attn_out_w", i).T)


def conformer_layer(w, i: int, x, pos_rows, rel_hi: int, n_heads: int,
                    allowed=None):
    def lin(h, name):
        return _mm(w, h, layer_weight(w, name, i).T)

    def ffn(h, a, b):
        return lin(F.silu(lin(h, a)), b)

    res = x + 0.5 * ffn(_ln(x, w, "norm_ff1", i), "ffn1_w1", "ffn1_w2")
    res = res + attention(w, i, _ln(res, w, "norm_attn", i), pos_rows,
                          rel_hi, n_heads, allowed)
    cur = lin(_ln(res, w, "norm_conv", i), "conv_pw1_w")
    cur = F.glu(cur, dim=-1)
    dw = layer_weight(w, "conv_dw_w", i)                         # [K, D]
    kk = dw.shape[0]
    cur = _conv(w, F.conv1d, F.pad(cur.T[None], (kk - 1, 0)),
                dw.T[:, None, :], groups=dw.shape[1])[0].T
    cur = F.silu(_ln(cur, w, "conv_ln", i))
    res = res + lin(cur, "conv_pw2_w")
    res = res + 0.5 * ffn(_ln(res, w, "norm_ff2", i), "ffn2_w1", "ffn2_w2")
    return _ln(res, w, "norm_final", i)


def encoder(w, hp: dict, x, allowed=None, rel=None) -> torch.Tensor:
    """The conformer layers over x [T, D]; rel (lo, hi): the relative
    positions that `allowed` lets through (default: all of them)."""
    if x.shape[0] == 0:
        return x
    lo, hi = rel or (1 - x.shape[0], x.shape[0] - 1)
    rows = _rel_pos_rows(w["pos_table"], lo, hi)
    for i in range(hp["n_layers"]):
        x = conformer_layer(w, i, x, rows, hi, hp["n_heads"], allowed)
    return x


def chunk_band(t: int, chunk: int, left: int, device) -> torch.Tensor:
    q = torch.arange(t, device=device)[:, None]
    k = torch.arange(t, device=device)[None, :]
    c = q // chunk
    return (k >= c * chunk - left) & (k < (c + 1) * chunk)


def stream_frames(hp: dict, right_context: int, n_samples: int) -> int:
    """Encoder frames a stream of n_samples is decoded over: every whole
    chunk after the 96 samples that prime the frontend, then the frames
    that the leftover mel frames still give."""
    shift_mel = hp["subsampling_factor"] * (1 + right_context)
    shift = shift_mel * HOP
    if n_samples < 96:
        return 0
    steps = (n_samples - 96) // shift
    left = mel_frames_available(n_samples) - shift_mel * steps
    tail = left // hp["subsampling_factor"] if left > 0 else 0
    return steps * (1 + right_context) + tail


def stream_encoder(w, hp: dict, audio, right_context: int) -> torch.Tensor:
    """A stream's encoder frames [n_frames, D] as the cache-aware streaming
    model gives them. Its last chunk, when the audio ends inside one, runs
    whole over the audio padded with zero samples, as a finalizing stream
    sends it, and its padded frames stay among the chunk's keys."""
    n = int(audio.shape[0])
    n_frames = stream_frames(hp, right_context, n)
    chunk = 1 + right_context
    chunks = -(-n_frames // chunk)
    shift = hp["subsampling_factor"] * chunk * HOP
    padded = F.pad(audio, (0, max(0, 96 + chunks * shift - n)))
    mel = log_mel(padded, w["pre.filterbank"], w["pre.window"])
    chunk_mel = 9 + hp["subsampling_factor"] * chunk
    zeros = mel.new_zeros
    full = torch.cat([zeros(9, mel.shape[1]), mel,
                      zeros(chunk_mel, mel.shape[1])])
    x = subsample(w, full)[2:2 + chunks * chunk]
    left = hp["att_left_context"]
    band = chunk_band(x.shape[0], chunk, left, x.device)
    return encoder(w, hp, x, band,
                   rel=(1 - chunk, left + chunk - 1))[:n_frames]


def max_seg_mel_frames(hp: dict) -> int:
    """The longest offline segment whose subsampled length fits the
    positional table (2 * max_pos_len - 1 rows)."""
    t = 8 * hp["max_pos_len"]
    while subsampled_len(t) > hp["max_pos_len"]:
        t -= 8
    return t


def subsampled_len(t: int) -> int:
    for _ in range(3):
        t = t // 2 + 1
    return t


def offline_encoder(w, hp: dict, audio) -> torch.Tensor:
    """A file's encoder frames: its mel cut into segments, each encoded
    alone with full attention, concatenated."""
    mel = log_mel(audio, w["pre.filterbank"], w["pre.window"])
    seg = max_seg_mel_frames(hp)
    parts = [encoder(w, hp, subsample(w, mel[s:s + seg]))
             for s in range(0, mel.shape[0], seg)]
    return torch.cat(parts) if parts else mel.new_zeros(0, hp["d_model"])


def _lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh, w=None):
    g = (x @ w_ih.T + h @ w_hh.T if w is None
         else _mm(w, x, w_ih.T) + _mm(w, h, w_hh.T)) + b_ih + b_hh
    i, f, gg, o = g.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c), c


def prediction_outputs(w, hp: dict, sequences: list[list[int]], device):
    """The prediction net's output before each token of each sequence and
    after its last, all sequences stepped side by side: a list of
    [len(seq) + 1, decoder_dim]; its first input is the blank."""
    emb = _f32(w["dec.embedding"])
    wi, wh = _f32(w["dec.w_ih"]), _f32(w["dec.w_hh"])
    bi, bh = _f32(w["dec.b_ih"]), _f32(w["dec.b_hh"])
    blank = hp["vocab_size"] - 1
    steps = max(len(s) for s in sequences) + 1
    prev = torch.full((len(sequences), steps), blank, device=device)
    for j, seq in enumerate(sequences):
        if seq:
            prev[j, 1:len(seq) + 1] = torch.tensor(seq, device=device)
    n = hp["decoder_dim"]
    h = [emb.new_zeros(len(sequences), n) for _ in range(2)]
    c = [emb.new_zeros(len(sequences), n) for _ in range(2)]
    outs = []
    for u in range(steps):
        h[0], c[0] = _lstm_cell(emb[prev[:, u]], h[0], c[0], wi[0], wh[0],
                                bi[0], bh[0], w)
        h[1], c[1] = _lstm_cell(h[0], h[1], c[1], wi[1], wh[1], bi[1], bh[1],
                                w)
        outs.append(h[1])
    out = torch.stack(outs, dim=1)                      # [S, steps, n]
    return [out[j, :len(seq) + 1] for j, seq in enumerate(sequences)]


def decisions(hp: dict, n_frames: int, served: list[tuple[int, int]]):
    """Every decision the program made over n_frames encoder frames, from
    its (token, frame) pairs in emission order: (frame, tokens emitted
    before it, the choice) each, the blank for a frame's end (none after a
    frame's tenth token); or the faults that make the sequence no RNN-T
    path: a frame out of range or out of order, more than MAX_SYMBOLS
    tokens a frame, a token id outside the vocabulary."""
    blank = hp["vocab_size"] - 1
    frames = [f for _, f in served]
    faults = []
    if any(b < a for a, b in zip(frames, frames[1:])):
        faults.append("frames out of order")
    if frames and (frames[0] < 0 or frames[-1] >= n_frames):
        faults.append(f"frame outside [0, {n_frames})")
    if any(not 0 <= tok < blank for tok, _ in served):
        faults.append("token id outside the vocabulary")
    per_frame = np.bincount(np.asarray(frames, dtype=np.int64),
                            minlength=n_frames) if frames and not faults \
        else np.zeros(n_frames, np.int64)
    if per_frame.max(initial=0) > MAX_SYMBOLS:
        faults.append(f"more than {MAX_SYMBOLS} tokens a frame")
    if faults:
        return None, faults
    t_idx, u_idx, choice = [], [], []
    u = 0
    for t in range(n_frames):
        for _ in range(int(per_frame[t])):
            t_idx.append(t)
            u_idx.append(u)
            choice.append(served[u][0])
            u += 1
        if per_frame[t] < MAX_SYMBOLS:
            t_idx.append(t)
            u_idx.append(u)
            choice.append(blank)
    return (np.asarray(t_idx), np.asarray(u_idx), np.asarray(choice)), []


def joint_logits(w, enc, pred, t_idx, u_idx, block: int = 8192):
    """The joint's logits at each (frame, tokens-so-far) position, in
    blocks: yields [n, vocab] tensors."""
    enc_proj = _mm(w, enc, _f32(w["joint.enc_w"]).T) + _f32(w["joint.enc_b"])
    dec_proj = _mm(w, pred, _f32(w["joint.dec_w"]).T) + _f32(w["joint.dec_b"])
    out_w, out_b = _f32(w["joint.out_w"]), _f32(w["joint.out_b"])
    t_idx = torch.as_tensor(t_idx, device=enc.device)
    u_idx = torch.as_tensor(u_idx, device=enc.device)
    for s in range(0, t_idx.shape[0], block):
        h = torch.relu(enc_proj[t_idx[s:s + block]]
                       + dec_proj[u_idx[s:s + block]])
        yield _mm(w, h, out_w.T) + out_b
