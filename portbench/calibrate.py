"""The blank bias of a run, chosen at set-up from the seed's own weights.

With random weights, how often greedy decoding emits depends steeply on
the blank's bias and moves with the seed: a bias that gives one token in
three frames for one seed gives none, or ten a frame, for another. So each
run sets the bias that brings its own model nearest the configuration's
`tokens_per_frame` (speech gives about one token every two to three
encoder frames), as the reference decodes clips of the run's own audio
in the cell's mode, and the work of a run is the same for every seed. Done in
float32 before the program is built; the program and the reference then
share the one bias tensor."""

from __future__ import annotations

import numpy as np
import torch

from . import gen
from .reference import asr as ref

GRID = np.arange(-8.0, 16.01, 0.125)


def greedy_rates(w: dict, hp: dict, enc: torch.Tensor, biases) -> np.ndarray:
    """Tokens per frame that greedy RNN-T decoding of enc [C, T, D] (C
    clips of T frames) emits at each bias, over all the clips: every (bias,
    clip) pair decoded side by side, one row each."""
    f32 = torch.float32
    dev = enc.device
    n_bias, n_clips, frames = len(biases), enc.shape[0], enc.shape[1]
    k = n_bias * n_clips
    blank = hp["vocab_size"] - 1
    emb = w["dec.embedding"].to(f32)
    wi, wh = w["dec.w_ih"].to(f32), w["dec.w_hh"].to(f32)
    bi, bh = w["dec.b_ih"].to(f32), w["dec.b_hh"].to(f32)
    out_w = w["joint.out_w"].to(f32)
    out_b = w["joint.out_b"].to(f32).repeat(k, 1)
    out_b[:, blank] = torch.tensor(biases, dtype=f32,
                                   device=dev).repeat_interleave(n_clips)
    enc_proj = (enc.to(f32) @ w["joint.enc_w"].to(f32).T
                + w["joint.enc_b"].to(f32)).repeat(n_bias, 1, 1)  # [k, T, J]
    n = hp["decoder_dim"]
    h = [torch.zeros(k, n, device=dev) for _ in range(2)]
    c = [torch.zeros(k, n, device=dev) for _ in range(2)]

    def pred(prev, h, c):
        h0, c0 = ref._lstm_cell(emb[prev], h[0], c[0], wi[0], wh[0], bi[0],
                                bh[0])
        h1, c1 = ref._lstm_cell(h0, h[1], c[1], wi[1], wh[1], bi[1], bh[1])
        return [h0, h1], [c0, c1]

    prev = torch.full((k,), blank, device=dev)
    hn, cn = pred(prev, h, c)
    dec = hn[1] @ w["joint.dec_w"].to(f32).T + w["joint.dec_b"].to(f32)
    tokens = torch.zeros(k, device=dev)
    for t in range(frames):
        live = torch.ones(k, dtype=torch.bool, device=dev)
        for _ in range(ref.MAX_SYMBOLS):
            logits = torch.relu(enc_proj[:, t] + dec) @ out_w.T + out_b
            emit = live & (logits.argmax(dim=-1) != blank)
            if not bool(emit.any()):
                break
            tok = logits.argmax(dim=-1)
            h2, c2 = pred(tok, hn, cn)
            m = emit[:, None]
            hn = [torch.where(m, a, b) for a, b in zip(h2, hn)]
            cn = [torch.where(m, a, b) for a, b in zip(c2, cn)]
            dec = torch.where(m, hn[1] @ w["joint.dec_w"].to(f32).T
                              + w["joint.dec_b"].to(f32), dec)
            tokens += emit.to(f32)
            live = emit
    per_row = tokens.view(n_bias, n_clips).sum(dim=1)
    return (per_row / max(1, n_clips * frames)).cpu().numpy()


def blank_bias(w: dict, conf: dict, right_context, pool: np.ndarray) -> float:
    """The grid's bias whose rate on the calibration clips (the
    configuration's `calibration_clips` clips of `calibration_s` seconds,
    spread evenly over the run's own audio pool) lies nearest
    `tokens_per_frame`; right_context None: the offline encoder."""
    hp = conf["model"]
    dev = w["pos_table"].device
    n, secs = int(conf["calibration_clips"]), float(conf["calibration_s"])
    size = min(int(secs * gen.SAMPLE_RATE), len(pool))
    starts = np.linspace(0, len(pool) - size, n).astype(np.int64)
    with torch.no_grad():
        clips = [torch.from_numpy(pool[a:a + size]).to(dev) for a in starts]
        encs = [ref.offline_encoder(w, hp, clip) if right_context is None
                else ref.stream_encoder(w, hp, clip, int(right_context))
                for clip in clips]
        frames = min(e.shape[0] for e in encs)
        rates = greedy_rates(w, hp, torch.stack([e[:frames] for e in encs]),
                             GRID)
    target = float(conf["tokens_per_frame"])
    return float(GRID[int(np.argmin(np.abs(np.log((rates + 1e-3)
                                                   / target))))])
