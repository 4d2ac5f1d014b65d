"""Log-mel frames: the CUDA kernel `csrc/mel_frames.cu` and its plain
PyTorch version (port of nemotron_tpu/ops/mel_pallas.py, kernel B2).

`mel_frames(buf, window512, filterbank, n_frames)` frames pre-emphasized
audio at hop 160, windows it, takes the 257-bin power spectrum, applies the
filterbank and `log(x + 2^-24)`. A CUDA tensor goes through the kernel (or
the call raises); a CPU tensor takes `mel_frames_ref`, which runs the DFT
against the f32 tables of `dft_bases`, as the JAX package does.

The kernel runs an FFT per frame over tiles of frames staged once in shared
memory. What it needs besides the call's tensors is built once and kept:
the twiddle table per device (`fft_twiddles`), the filterbank's kernel
layout per filterbank tensor (`filterbank_layout`) and the tile per shape
(`mel_plan`).
"""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from .attn_kernel import sm_count

N_FFT = 512
HOP = 160
N_BINS = N_FFT // 2 + 1
LOG_ZERO_GUARD = 2.0 ** -24
N_MELS = (32, 80, 128)         # the filterbank heights the wrapper takes
FRAME_TILES = (16, 8, 4)       # frames per block the plan picks from
TWIDDLES = 256 + N_BINS        # rows of twiddle_table (kTwiddles in the .cu)


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


class TensorMemo:
    """fn(t) computed once per tensor object and its version counter: a new
    tensor, or one changed in place, gets a new value. Entries of tensors
    that no longer exist are dropped."""

    def __init__(self, fn):
        self.fn = fn
        self.entries: dict = {}
        functools.update_wrapper(self, fn)

    def __call__(self, t):
        hit = self.entries.get(id(t))
        if hit is not None and hit[0]() is t and hit[1] == t._version:
            return t if hit[2] is None else hit[2]
        value = self.fn(t)
        self.entries = {k: e for k, e in self.entries.items()
                        if e[0]() is not None}
        # a value that is the tensor itself is not held (it would keep the
        # key alive)
        self.entries[id(t)] = (weakref.ref(t), t._version,
                               None if value is t else value)
        return value


def twiddle_table() -> np.ndarray:
    """The kernel's twiddles [TWIDDLES, 2] float64 (re, im): row k1 * 16 + j
    holds W256^(j k1) for the 16 x 16 steps of the 256-point FFT, row
    256 + k holds W512^k (k <= 256) for the split into 257 bins;
    W_N = e^(-2 pi i / N)."""
    j = np.arange(16)
    w = np.concatenate([
        np.exp(-2j * np.pi * np.outer(j, j).reshape(-1) / 256),  # [k1][j]
        np.exp(-2j * np.pi * np.arange(N_BINS) / N_FFT)])
    return np.stack([w.real, w.imag], axis=1)


@functools.lru_cache(maxsize=8)
def fft_twiddles(device: torch.device) -> torch.Tensor:
    return torch.tensor(twiddle_table(), device=device)


class FilterbankLayout(NamedTuple):
    weights: torch.Tensor  # [n_w] f32: each mel's band of weights, mel
                           # after mel, zero-padded to a multiple of 4
    bands: torch.Tensor    # [n_mels, 4] int32: lo, hi (the mel's non-zero
                           # bins [lo, hi)), base (bin k's weight at
                           # weights[base + k]), 0


@TensorMemo
def filterbank_layout(filterbank) -> FilterbankLayout:
    """The kernel's layout of a filterbank [n_mels, 257] f32: each mel's
    band [lo, hi) from its first to its last non-zero bin (empty for a zero
    row) and the weights of the bands packed one after another, so the
    kernel stages all of them with one bulk copy. A dense filterbank has
    full bands (257 x n_mels weights); a slaney one its triangles. Built
    once per tensor and version (one copy to the host)."""
    fb = filterbank.detach().cpu().numpy()
    nz = fb != 0
    any_nz = nz.any(axis=1)
    lo = np.where(any_nz, nz.argmax(axis=1), 0)
    hi = np.where(any_nz, nz.shape[1] - nz[:, ::-1].argmax(axis=1), 0)
    off = np.concatenate([[0], np.cumsum(hi - lo)])
    weights = np.zeros(-(-off[-1] // 4) * 4, np.float32)
    for m in range(fb.shape[0]):
        weights[off[m]:off[m + 1]] = fb[m, lo[m]:hi[m]]
    bands = np.stack([lo, hi, off[:-1] - lo, np.zeros_like(lo)],
                     axis=1).astype(np.int32)
    dev = filterbank.device
    return FilterbankLayout(torch.tensor(weights, device=dev),
                            torch.tensor(bands, device=dev))


@functools.lru_cache(maxsize=64)
def mel_plan(batch: int, n_frames: int, wide: bool, sms: int) -> int:
    """Frames per block (16 threads each). With wide bands (a dense
    filterbank) the filterbank product is a block's longest chain, so 16:
    its 256 threads halve each one's share even where the FFT leaves half
    of them idle. Otherwise the largest tile of FRAME_TILES, no longer than
    the call's frames, that still gives one block per SM (whole streams at
    the tick's B=256 x 8, 375 tiles for a 60 s utterance), else the
    smallest, so few streams spread over more blocks. (tools/gemm_turns.py
    --only mel --plans times every tile.)"""
    if wide:
        return FRAME_TILES[0]
    for f in FRAME_TILES:
        if f <= n_frames and batch * -(-n_frames // f) >= sms:
            return f
    return FRAME_TILES[-1]


def wide_bands(lay: FilterbankLayout) -> bool:
    """Whether the bands average more than a quarter of the bins (a dense
    filterbank; a slaney one averages a few)."""
    return lay.weights.numel() > lay.bands.shape[0] * N_BINS // 4


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


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
    if n_mels not in N_MELS:
        raise ValueError(f"mel_frames: n_mels {n_mels} not in {N_MELS}")
    if (n_frames - 1) * HOP + N_FFT > n_buf:
        raise ValueError(f"mel_frames: {n_buf} samples < {n_frames} frames")
    if b > 65535:  # the grid's y
        raise ValueError(f"mel_frames: batch {b} > 65535")
    buf = buf.contiguous()
    window512 = window512.contiguous()
    # the bulk copies: 16-byte aligned rows and window
    if n_buf % 4 or not _aligned(buf) or not _aligned(window512):
        raise ValueError(
            f"mel_frames: buf rows of {n_buf} samples at {buf.data_ptr():#x} "
            f"and window at {window512.data_ptr():#x} must be 16-byte aligned")
    lay = filterbank_layout(filterbank)
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32,
                      device=buf.device)
    kernels.MEL_FRAMES.launch(
        "mel_frames_f32", buf.data_ptr(), window512.data_ptr(),
        fft_twiddles(buf.device).data_ptr(), lay.weights.data_ptr(),
        lay.bands.data_ptr(), out.data_ptr(), b, n_buf, n_frames, n_mels,
        lay.weights.numel(),
        mel_plan(b, n_frames, wide_bands(lay), sm_count(buf.device)))
    return out
