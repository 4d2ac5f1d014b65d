"""80-mel log-mel frontend of the diarization nets, as batched matmuls (port
of nemotron_tpu/diarize/audio.py, the same math):

  - pre-emphasis in place (y[0] = x[0]);
  - STFT center=True with zero padding, n_frames = 1 + n // hop;
  - the 400-sample window centred in a 512-point frame, a real DFT by
    matmul (ops.mel_kernel.dft_bases), power -> filterbank ->
    log(x + 2^-24);
  - optional per-feature normalisation over t_valid with Bessel (n - 1),
    1e-5 added to the std;
  - frames >= t_valid zeroed; time padded to a multiple of 16.

Every window size is fixed (VAD 10080 samples -> 64 mel frames; speaker
24000 -> 160), so each call site batches many windows of one shape."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.mel_kernel import dft_bases

N_FFT = 512
HOP = 160
WIN_SIZE = 400
PREEMPH = 0.97
GUARD = 2.0 ** -24
PAD_TO = 16

VAD_WINDOW_SAMPLES = 10080   # 0.63 s
VAD_MEL_VALID = 63
VAD_MEL_PADDED = 64
SPK_WINDOW_SAMPLES = 24000   # 1.5 s
SPK_MEL_VALID = 150
SPK_MEL_PADDED = 160

_BASES: dict = {}  # device -> (cos, sin) DFT bases [n_fft, n_bins] f32


def _bases(device: torch.device):
    if device not in _BASES:
        cr, ci = dft_bases(N_FFT)
        _BASES[device] = (torch.tensor(cr, device=device),
                          torch.tensor(ci, device=device))
    return _BASES[device]


def _frame_geometry(n_samples: int) -> tuple[int, int, int]:
    """(n_frames, left pad, right pad) of center=True framing over the
    zero-padded signal (n_fft / 2 on the left, the right as needed)."""
    n_frames = 1 + n_samples // HOP
    half = N_FFT // 2
    pad_right = max(0, (n_frames - 1) * HOP - half + N_FFT - n_samples)
    return n_frames, half, pad_right


def logmel(audio: torch.Tensor, fb: torch.Tensor, window: torch.Tensor,
           per_feature_norm: bool) -> torch.Tensor:
    """audio [B, n_samples] f32 in [-1, 1] -> mel [B, T_padded, n_mels]."""
    b, n = audio.shape
    n_frames, half, pad_right = _frame_geometry(n)
    t_valid = n // HOP

    emph = torch.cat([audio[:, :1], audio[:, 1:] - PREEMPH * audio[:, :-1]],
                     dim=1)
    padded = F.pad(emph, (half, pad_right))
    frames = padded.unfold(1, N_FFT, HOP)[:, :n_frames]  # [B, frames, n_fft]

    off = (N_FFT - WIN_SIZE) // 2
    win = F.pad(window.float(), (off, N_FFT - WIN_SIZE - off))
    cr, ci = _bases(audio.device)
    x = frames * win
    re = x @ cr
    im = x @ ci
    power = re * re + im * im
    mel = torch.log(power @ fb.T + GUARD)  # [B, frames, n_mels]

    if per_feature_norm:
        seg = mel[:, :t_valid]
        mean = seg.mean(dim=1, keepdim=True)
        var = ((seg - mean) ** 2).sum(dim=1, keepdim=True) / max(
            1, t_valid - 1)
        std = torch.sqrt(var) + 1e-5
        mel = torch.cat([(seg - mean) / std,
                         torch.zeros_like(mel[:, t_valid:])], dim=1)
    else:
        valid = (torch.arange(n_frames, device=mel.device) < t_valid)
        mel = mel * valid.to(mel.dtype)[None, :, None]

    t_padded = t_valid + ((-t_valid) % PAD_TO)
    if t_padded > n_frames:
        mel = F.pad(mel, (0, 0, 0, t_padded - n_frames))
    else:
        mel = mel[:, :t_padded]
    return mel
