"""The tiny CTC model written out plainly in float32: the log-mel of 400-sample
Hann-windowed frames every 160 samples (512-point FFT, no padding), less
each frame's mean over its bands; STACK frames stacked into one encoder
frame (the tail that fills no encoder frame dropped); one linear layer to
the vocabulary's logits, the blank last. A weight dict that carries
"_round" rounds both operands of the linear layer with it (judge.py's
control)."""

from __future__ import annotations

import torch

HOP = 160
WIN = 400
N_FFT = 512
STACK = 8


def log_mel(w: dict, audio_i16: torch.Tensor) -> torch.Tensor:
    """int16 samples [N] -> [frames, n_mels], each frame less its mean."""
    x = audio_i16.to(torch.float32) / 32768.0
    if x.shape[0] < WIN:
        return x.new_zeros(0, w["pre.filterbank"].shape[0])
    frames = x.unfold(0, WIN, HOP) * w["pre.window"]
    spec = torch.fft.rfft(frames, n=N_FFT)
    power = spec.real ** 2 + spec.imag ** 2
    mel = torch.log(power @ w["pre.filterbank"].T + 2.0 ** -24)
    return mel - mel.mean(dim=-1, keepdim=True)


def encoder(w: dict, audio_i16: torch.Tensor) -> torch.Tensor:
    """[frames // STACK, STACK * n_mels]: the stacked log-mel frames."""
    mel = log_mel(w, audio_i16)
    t = mel.shape[0] // STACK
    return mel[:t * STACK].reshape(t, STACK * mel.shape[1])


def logits(w: dict, enc: torch.Tensor) -> torch.Tensor:
    """[frames, vocab] of encoder frames."""
    r = w.get("_round")
    a, b = enc, w["out_w"].T
    return (a @ b if r is None else r(a) @ r(b)) + w["out_b"]
