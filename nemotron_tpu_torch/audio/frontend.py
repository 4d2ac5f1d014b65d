"""Host-side streaming audio frontend (port of
nemotron_tpu/audio/frontend.py): sample bookkeeping on the host, the mel
frames through kernel B2 on the card (`ops/mel_kernel.mel_frames`; its plain
version on the CPU).

The stateful semantics of the reference preprocessor: i16 -> f32 scale
1/32768, pre-emphasis with a carried last sample, an audio buffer that
starts with n_fft/2 zeros (centre padding), frames of 512 at hop 160, and the
buffer advanced by n_frames * hop after each call. Frame counts are padded
to a multiple of 8 (the extra frames are computed and dropped), which
bounds the shapes the kernel is given as the JAX package bounds its
compiles.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import mel as melops
from ..params import upload
from .. import native


def _bucket(n_frames: int) -> int:
    return -(-n_frames // 8) * 8


def _buf_len(n_frames: int) -> int:
    return (n_frames - 1) * melops.HOP + melops.N_FFT


class StreamPreprocessor:
    """Stateful per-stream mel frontend. filterbank [n_mels, 257] and
    window [400] are tensors or arrays; the filterbank fixes the device (a
    tensor's own, the CPU for an array)."""

    def __init__(self, filterbank, window):
        self.device = (filterbank.device if isinstance(filterbank, torch.Tensor)
                       else torch.device("cpu"))
        self.fb = torch.as_tensor(filterbank).to(self.device, torch.float32)
        self.window512 = melops.padded_window(
            torch.as_tensor(window).to(self.device))
        self.n_fft = melops.N_FFT
        self.hop = melops.HOP
        self.n_mels = int(self.fb.shape[0])
        self.reset()

    def reset(self) -> None:
        # centre padding: n_fft/2 zeros
        self.buf = np.zeros(self.n_fft // 2, dtype=np.float32)
        self.last_sample = 0.0

    def n_frames_for(self, n_new_samples: int) -> int:
        avail = len(self.buf) + n_new_samples
        if avail < self.n_fft:
            return 0
        return (avail - self.n_fft + self.hop) // self.hop

    def _push(self, audio) -> int:
        """Pre-emphasize and append `audio`; returns the frames ready."""
        audio = np.asarray(audio)
        if audio.size:
            emph, self.last_sample = native.pcm_to_f32_preemph(
                audio, melops.PREEMPH, self.last_sample)
            self.buf = np.concatenate([self.buf, emph])
        return self.n_frames_for(0)

    def _take(self, n_frames: int, n_pad: int) -> np.ndarray:
        """The samples of n_frames frames, zero-padded to n_pad frames'
        worth; the buffer advances by n_frames * hop."""
        out = np.zeros(_buf_len(n_pad), dtype=np.float32)
        need = _buf_len(n_frames)
        out[:need] = self.buf[:need]
        self.buf = self.buf[n_frames * self.hop:].copy()
        return out

    def process(self, audio_i16) -> np.ndarray:
        """audio_i16: int16 (or float in [-1, 1]) samples. Returns log-mel
        [n_frames, n_mels] f32 on the host (possibly empty)."""
        if np.asarray(audio_i16).size == 0:
            return np.zeros((0, self.n_mels), dtype=np.float32)
        n_frames = self._push(audio_i16)
        if n_frames <= 0:
            return np.zeros((0, self.n_mels), dtype=np.float32)
        n_pad = _bucket(n_frames)
        buf = torch.tensor(self._take(n_frames, n_pad), device=self.device)
        mel = melops.mel_frames(buf[None], self.window512, self.fb, n_pad)
        return mel[0, :n_frames].cpu().numpy()


def process_many_start(pps: list[StreamPreprocessor], audios: list):
    """The first half of process_many (JAX frontend.py's): the host
    bookkeeping per stream and the frames of every stream enqueued as one
    batched mel call, without waiting for it (on the card the samples go
    up through pinned memory, params.upload, and the mel is enqueued;
    nothing is read back). Returns the handle for process_many_finish, or
    None when no stream has a frame ready."""
    counts = [pp._push(a) for pp, a in zip(pps, audios)]
    n_max = max(counts, default=0)
    if n_max <= 0:
        return None
    n_pad = _bucket(n_max)
    bufs = np.zeros((len(pps), _buf_len(n_pad)), dtype=np.float32)
    for i, (pp, cnt) in enumerate(zip(pps, counts)):
        if cnt > 0:
            bufs[i] = pp._take(cnt, n_pad)
    pp0 = pps[0]
    mel = melops.mel_frames(upload(bufs, pp0.device), pp0.window512,
                            pp0.fb, n_pad)
    return mel, counts


def process_many_finish(handle) -> list[np.ndarray]:
    """The second half: wait for the mel call of `handle` and unpack it
    per stream."""
    mel, counts = handle
    mel = mel.cpu().numpy()
    return [mel[i, :cnt] for i, cnt in enumerate(counts)]


def process_many(pps: list[StreamPreprocessor],
                 audios: list) -> list[np.ndarray]:
    """Advance many stream preprocessors with ONE mel call: the host
    bookkeeping runs per stream, the frames of every stream go to one
    batched launch (frame counts padded to the bucketed maximum), and the
    result is unpacked per stream (process_many_start, then
    process_many_finish)."""
    handle = process_many_start(pps, audios)
    if handle is None:
        return [np.zeros((0, pp.n_mels), np.float32) for pp in pps]
    return process_many_finish(handle)


def mel_full(audio_i16, filterbank, window) -> np.ndarray:
    """One-shot (offline) mel of a whole utterance: one process() call on a
    fresh stream."""
    return StreamPreprocessor(filterbank, window).process(audio_i16)
