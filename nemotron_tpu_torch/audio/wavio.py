"""Minimal RIFF/WAV reader for 16-bit PCM (CLI convenience; the reference
consumes raw s16le only)."""

from __future__ import annotations

import struct

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns (int16 samples mono, sample_rate). Multi-channel audio is
    averaged to mono."""
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            tag, size = struct.unpack("<4sI", hdr)
            payload = f.read(size)
            if size % 2:
                f.read(1)
            if tag == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif tag == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        audio_fmt, n_ch, rate, _br, _ba, bits = fmt
        if audio_fmt != 1 or bits != 16:
            raise ValueError(
                f"{path}: only 16-bit PCM supported (fmt={audio_fmt}, bits={bits})"
            )
        samples = np.frombuffer(data, dtype="<i2")
        if n_ch > 1:
            samples = samples.reshape(-1, n_ch).mean(axis=1).astype(np.int16)
        return samples, rate


def maybe_read_audio(path: str) -> np.ndarray:
    """Read .wav (validated 16 kHz) or raw s16le PCM."""
    if path.endswith(".wav"):
        samples, rate = read_wav(path)
        if rate != 16000:
            raise ValueError(f"{path}: expected 16 kHz, got {rate}")
        return samples
    return np.fromfile(path, dtype="<i2")
