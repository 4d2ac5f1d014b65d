"""Log-mel frames: the CUDA kernel `csrc/mel_frames.cu` and its plain
PyTorch version (port of nemotron_tpu/ops/mel_pallas.py, kernel B2).

`mel_frames(buf, window512, filterbank, n_frames)` frames pre-emphasized
audio at hop 160, windows it, takes the 257-bin power spectrum against the
f32 DFT tables of `dft_bases`, applies the filterbank and `log(x + 2^-24)`.
A CUDA tensor goes through the kernel (or the call raises); a CPU tensor
takes `mel_frames_ref`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels

N_FFT = 512
HOP = 160
N_BINS = N_FFT // 2 + 1
LOG_ZERO_GUARD = 2.0 ** -24


@functools.lru_cache(maxsize=2)
def dft_bases(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT basis matrices [n_fft, n_bins] (forward, e^{-2πi k n / N}),
    the same f32 tables as nemotron_tpu/ops/mel.py:dft_bases."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=8)
def dft_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    cr, ci = dft_bases()
    return (torch.tensor(cr, device=device), torch.tensor(ci, device=device))


def mel_from_frames(frames, window512, filterbank):
    """frames: [..., n_frames, n_fft] pre-emphasized windows; window512:
    [n_fft]; filterbank: [n_mels, n_bins] -> log-mel [..., n_frames, n_mels]."""
    cr, ci = dft_tables(frames.device)
    x = frames * window512
    re = x @ cr
    im = x @ ci
    power = re * re + im * im
    mel = power @ filterbank.T
    return torch.log(mel + LOG_ZERO_GUARD)


def mel_frames_ref(buf, window512, filterbank, n_frames: int):
    """Plain PyTorch version. buf [B, n_buf] f32 pre-emphasized samples,
    window512 [512], filterbank [n_mels, 257] -> log-mel [B, n_frames, n_mels]."""
    frames = buf.unfold(-1, N_FFT, HOP)[:, :n_frames]  # [B, n_frames, 512]
    return mel_from_frames(frames, window512, filterbank)


def mel_frames(buf, window512, filterbank, n_frames: int):
    """Log-mel frames through the CUDA kernel (plain version on CPU)."""
    if buf.device.type == "cpu":
        return mel_frames_ref(buf, window512, filterbank, n_frames)
    if buf.device.type != "cuda":
        raise ValueError(f"mel_frames: unsupported device {buf.device}")
    b, n_buf = buf.shape
    n_mels, n_bins = filterbank.shape
    for name, t in (("buf", buf), ("window512", window512),
                    ("filterbank", filterbank)):
        if t.dtype != torch.float32 or t.device != buf.device:
            raise ValueError(f"mel_frames: {name} must be f32 on {buf.device}")
    if window512.shape != (N_FFT,) or n_bins != N_BINS:
        raise ValueError(
            f"mel_frames: window {tuple(window512.shape)} / filterbank "
            f"{tuple(filterbank.shape)} do not match n_fft {N_FFT}")
    if (n_frames - 1) * HOP + N_FFT > n_buf:
        raise ValueError(f"mel_frames: {n_buf} samples < {n_frames} frames")
    buf = buf.contiguous()
    window512 = window512.contiguous()
    fb_t = filterbank.T.contiguous()  # [257, n_mels]: coalesced over mels
    cr, ci = dft_tables(buf.device)
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32,
                      device=buf.device)
    kernels.MEL_FRAMES.launch(
        "mel_frames_f32", buf.data_ptr(), window512.data_ptr(), cr.data_ptr(),
        ci.data_ptr(), fb_t.data_ptr(), out.data_ptr(), b, n_buf, n_frames,
        n_mels)
    return out
