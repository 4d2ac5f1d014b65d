"""A second architecture, made of new files only: a tiny greedy CTC model
(one linear layer over stacked log-mel frames; reference.py), served
offline by a plain torch program (program.py). The CPU tests copy this
directory into a tiny benchmark's archs/tiny_ctc/ beside a configuration
that names it and its cells (test_portbench_archs.py); it fills in what
portbench/archs/__init__.py lists."""

from __future__ import annotations

import numpy as np
import torch

from portbench import gen

from . import program, reference

KINDS = ("offline",)


def make_weights(conf: dict, seed: int, device) -> dict:
    hp = conf["model"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n_in = reference.STACK * hp["n_mels"]
    bins = reference.N_FFT // 2 + 1
    return {
        "pre.filterbank": torch.rand(hp["n_mels"], bins, generator=g,
                                     device=device) / bins,
        "pre.window": torch.hann_window(reference.WIN, periodic=False,
                                        device=device),
        "out_w": torch.randn(hp["vocab_size"], n_in, generator=g,
                             device=device) * n_in ** -0.5,
        "out_b": torch.zeros(hp["vocab_size"], device=device)}


def set_blank_bias(w: dict, bias: float) -> None:
    w["out_b"][-1] = bias


def has_q4_0_control(conf: dict) -> bool:
    return False


def program_model(conf: dict, w: dict, device, q4_0: bool = False):
    return program.Program(w, device)


def encoder(w: dict, conf: dict, audio, right_context):
    """Offline only: every frame sees the whole file alike."""
    return reference.encoder(w, audio)


def greedy_rates(w: dict, conf: dict, enc: torch.Tensor, biases):
    """Tokens per frame greedy CTC emits from enc [clips, frames, in] at
    each of the blank's biases."""
    base = reference.logits(w, enc)                     # [C, T, V]
    rates = []
    for b in biases:
        lg = base.clone()
        lg[..., -1] += float(b) - float(w["out_b"][-1])
        lab = lg.argmax(dim=-1)
        prev = torch.cat([torch.full_like(lab[:, :1], lg.shape[-1] - 1),
                          lab[:, :-1]], dim=1)
        emit = (lab != lg.shape[-1] - 1) & (lab != prev)
        rates.append(float(emit.sum()) / max(1, lab.numel()))
    return np.asarray(rates)


def frame_seconds(conf: dict) -> float:
    return reference.STACK * reference.HOP / gen.SAMPLE_RATE


def served_path(conf: dict, sample: dict) -> list[tuple[int, int]]:
    ids, secs = gen.parse_text(sample["text"])
    return [(t, int(round(s / frame_seconds(conf))))
            for t, s in zip(ids, secs)]


def decisions(conf: dict, n_frames: int, path):
    """One decision a frame: the token emitted there, or -1 where none
    was; or the faults that make the path no greedy CTC output."""
    blank = conf["model"]["vocab_size"] - 1
    frames = [f for _, f in path]
    faults = []
    if any(b <= a for a, b in zip(frames, frames[1:])):
        faults.append("frames not increasing")
    if frames and (frames[0] < 0 or frames[-1] >= n_frames):
        faults.append(f"frame outside [0, {n_frames})")
    if any(not 0 <= tok < blank for tok, _ in path):
        faults.append("token id outside the vocabulary")
    if faults:
        return None, faults
    emitted = [-1] * n_frames
    for tok, f in path:
        emitted[f] = tok
    return emitted, []


def decision_blocks(w: dict, conf: dict, judged, device):
    """A block a sample: its frames' reference logits and the program's
    choice at each. Where nothing was emitted the program chose the blank
    or repeated the label of the frame before: the one of the two that the
    reference ranks higher, while the label runs on."""
    blank = conf["model"]["vocab_size"] - 1
    for enc, _, emitted in judged:
        lg = reference.logits(w, enc)
        rows = lg.tolist()
        choice, run = [], None
        for row, tok in zip(rows, emitted):
            if tok >= 0:
                run = c = tok
            else:
                c = run if run is not None and row[run] > row[blank] \
                    else blank
                run = None if c == blank else run
            choice.append(c)
        yield lg, torch.tensor(choice, dtype=torch.int64, device=device)


def frame_flops(hp: dict) -> float:
    """The linear layer of one encoder frame."""
    return 2.0 * reference.STACK * hp["n_mels"] * hp["vocab_size"]


def subsampled_len(mel_frames: int) -> int:
    return mel_frames // reference.STACK


def max_seg_mel_frames(hp: dict) -> None:
    """No segments: a file is one pass."""
    return None


def offline_call_flops(hp: dict, samples, segment, iterations) -> float:
    """Every file's own encoder frames through the linear layer."""
    return sum(subsampled_len((n - reference.WIN) // reference.HOP + 1)
               * frame_flops(hp) for n in samples if n >= reference.WIN)
