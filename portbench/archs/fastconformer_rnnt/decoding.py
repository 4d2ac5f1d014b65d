"""The RNN-T greedy rule as the harness applies it: how often it emits at
each blank bias (calibrate.py), and, for judge.py, the decisions of a
served path and the reference's logits at each of them."""

from __future__ import annotations

import numpy as np
import torch

from . import reference as ref


def greedy_rates(w: dict, conf: dict, enc: torch.Tensor,
                 biases) -> np.ndarray:
    """Tokens per frame that greedy RNN-T decoding of enc [C, T, D] (C
    clips of T frames) emits at each bias, over all the clips: every (bias,
    clip) pair decoded side by side, one row each."""
    hp = conf["model"]
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


def decisions(conf: dict, n_frames: int, path: list[tuple[int, int]]):
    """(the decisions of a served path over n_frames encoder frames, []),
    or (None, its faults): reference.decisions."""
    return ref.decisions(conf["model"], n_frames, path)


def decision_blocks(w: dict, conf: dict, judged: list, device):
    """The reference's joint logits at every decision of each judged
    sample, in blocks: (logits [n, vocab], the served choice [n]). judged:
    [(encoder frames, served path, decisions)]. The prediction net runs
    over every sample's tokens side by side, before the first block."""
    preds = ref.prediction_outputs(w, conf["model"],
                                   [[t for t, _ in p] for _, p, _ in judged],
                                   device)

    def blocks():
        for (enc, _, (t_idx, u_idx, choice)), pred in zip(judged, preds):
            start = 0
            for logits in ref.joint_logits(w, enc, pred, t_idx, u_idx):
                n = logits.shape[0]
                yield logits, torch.as_tensor(choice[start:start + n],
                                              device=device)
                start += n

    return blocks()
