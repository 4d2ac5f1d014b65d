"""Streaming mel-spectrogram frontend (port of nemotron_tpu/ops/mel.py).

16 kHz, window 400 centred in a 512-point frame, hop 160, pre-emphasis 0.97,
128 mels, log guard 2^-24, power 2 (NeMo AudioToMelSpectrogramPreprocessor).
The spectral work runs in `mel_kernel.mel_frames` — the CUDA kernel on the
card — and this module keeps the carries around it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .mel_kernel import (HOP, N_FFT, TensorMemo, dft_bases,  # noqa: F401
                         mel_frames, mel_from_frames)

PREEMPH = 0.97


def padded_window(window):
    """Centre the 400-sample GGUF window in the 512-point frame."""
    window = window.to(torch.float32)
    pad = (N_FFT - window.shape[0]) // 2
    return F.pad(window, (pad, N_FFT - window.shape[0] - pad))


# The tick's frontend constants, built once per params tensor (and again
# only if that tensor changes in place) instead of on every tick.
window512_of = TensorMemo(padded_window)
filterbank_f32 = TensorMemo(lambda fb: fb.to(torch.float32))


def frame_signal(audio, n_frames: int):
    """audio: [..., n_samples] -> overlapping frames [..., n_frames, n_fft]
    (frame t starts at t*HOP)."""
    return audio.unfold(-1, N_FFT, HOP)[..., :n_frames, :]


def preemphasis(audio, last_sample):
    """audio: [..., N] float; last_sample: [...] carried from the previous call."""
    prev = torch.cat([last_sample[..., None], audio[..., :-1]], dim=-1)
    return audio - PREEMPH * prev


def mel_step(audio, tail, last_sample, window512, filterbank, *, n_frames):
    """One streaming frontend step (batched), as nemotron_tpu/ops/mel.py:mel_step.

    audio:       [B, n_new] raw samples already scaled to [-1, 1]
    tail:        [B, tail_len] carried pre-emphasized samples
    last_sample: [B] carried raw sample for pre-emphasis continuity
    Returns (mel [B, n_frames, n_mels], new_tail [B, tail_len], new_last [B]).
    The tail keeps its length; n_frames*HOP samples leave from the front.
    """
    emph = preemphasis(audio, last_sample)
    new_last = audio[..., -1]
    buf = torch.cat([tail, emph], dim=-1)
    mel = mel_frames(buf, window512, filterbank, n_frames)
    new_tail = buf[..., n_frames * HOP:]
    new_tail = new_tail[..., new_tail.shape[-1] - tail.shape[-1]:]
    return mel, new_tail, new_last
