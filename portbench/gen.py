"""The general traffic generator that the traffic kinds share. Every seed draws
the same set of sizes and gaps (stratified quantiles of the mix's
distributions), in another order, with other audio: the work of a run is
fixed by the mix, and the seed moves only its order and content."""

from __future__ import annotations

import math
import re

import numpy as np

SAMPLE_RATE = 16000


def rng(seed: int, stream: str) -> np.random.Generator:
    """A generator of its own for each use of the seed."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1),
                                  sum(map(ord, stream))])


def quantiles(n: int, r: np.random.Generator) -> np.ndarray:
    """(i + 0.5) / n for i < n, in an order drawn from r."""
    return r.permutation((np.arange(n) + 0.5) / n)


def log_uniform(u, lo: float, hi: float) -> np.ndarray:
    return lo * (hi / lo) ** np.asarray(u)


def log_uniform_mean(lo: float, hi: float) -> float:
    return (hi - lo) / np.log(hi / lo)


def residual_lives(u, v, lo: float, hi: float, floor: float) -> np.ndarray:
    """What is left of the lives of streams found live at a random time,
    lives log-uniform on [lo, hi]: a length-biased life (uniform on
    [lo, hi]: x times the 1/x density) less a uniform share of it."""
    life = lo + (hi - lo) * np.asarray(u)
    return np.maximum(life * (1.0 - np.asarray(v)), floor)


def exp_gaps(n: int, rate: float, r: np.random.Generator) -> np.ndarray:
    """n gaps of a Poisson process of `rate` per second."""
    return -np.log1p(-quantiles(n, r)) / rate


def mix_pool(mix: dict, seed: int, device) -> np.ndarray:
    """The run's audio: a pool a second longer than the mix's longest
    stream or file, which every stream and file is a slice of."""
    hi = (mix["life_s"] if "life_s" in mix else mix["length_s"])[1]
    return audio_pool(hi + 1.0, seed, device)


def audio_pool(seconds: float, seed: int, device) -> np.ndarray:
    """int16 audio at 16 kHz with speech-like variation, made on `device`
    from `seed`: noise shaped by a spectral envelope that drifts every
    100 ms (random gains in 24 bands, in dB, interpolated over time and
    frequency: formants and loudness that move) and a gliding pitched tone,
    overlap-added in 20 ms frames. The model's weights are random, so the
    content is not speech; what a mix fixes is lengths and timing, and what
    this gives is frames whose spectra differ, as speech's do."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2 ** 63 - 1))
    f32 = dict(dtype=torch.float32, device=device)

    def normal(*shape):
        return torch.randn(shape, generator=g, **f32)

    hop, n_fft = 320, 640
    n = int(seconds * SAMPLE_RATE)
    frames = n // hop + 2
    bins = n_fft // 2 + 1
    coarse = frames // 5 + 2
    gains = 8.0 * normal(1, 1, coarse, 24) + 6.0 * normal(1, 1, coarse, 1)
    env = torch.nn.functional.interpolate(            # dB, [frames, bins]
        gains, size=(frames, bins), mode="bilinear", align_corners=True)[0, 0]
    tilt = -6.0 * torch.log2(1.0 + torch.arange(bins, **f32) / 16.0)
    mag = torch.exp((env + tilt) * (math.log(10.0) / 20.0))
    spec = torch.complex(mag * normal(frames, bins), mag * normal(frames, bins))
    chunks = torch.fft.irfft(spec, n=n_fft, dim=1) * torch.hann_window(
        n_fft, periodic=False, **f32)
    x = torch.zeros((frames + 1) * hop, **f32)
    for k in range(2):  # overlap-add: frames k, k+2, ... do not overlap
        part = chunks[k::2].reshape(-1)
        x[k * hop:k * hop + part.numel()] += part
    x = x[:n]
    # the pitch glides slowly; its phase in float64 over the whole pool
    t = torch.arange(n, dtype=torch.float64, device=device) / SAMPLE_RATE
    f0 = 150.0 + 60.0 * torch.sin(2 * math.pi * 0.3 * t
                                  + 6.3 * float(torch.rand(1, generator=g,
                                                           **f32)))
    tone = torch.sin(torch.cumsum(2 * math.pi * f0 / SAMPLE_RATE, 0)).float()
    loud = mag.mean(dim=1).repeat_interleave(hop)[:n]
    x = 0.08 * (x / x.std() + 0.5 * tone * loud / loud.mean())
    return (x.clamp(-1.0, 1.0) * 32767.0).to(torch.int16).cpu().numpy()


_WORD = re.compile(r" (?:\{(\d+\.\d+)\})?w(\d+)")


def parse_text(text: str) -> tuple[list[int], list[float]]:
    """Served text (one word ▁w<id> a token, as the architectures'
    vocabularies have it, with timestamps where asked) -> (token ids,
    seconds or [])."""
    ids, secs = [], []
    pos = 0
    for m in _WORD.finditer(text):
        if m.start() != pos:
            raise ValueError(f"unparsable served text at {pos}: "
                             f"{text[pos:pos + 40]!r}")
        pos = m.end()
        ids.append(int(m.group(2)))
        if m.group(1) is not None:
            secs.append(float(m.group(1)))
    if pos != len(text):
        raise ValueError(f"unparsable served text at {pos}: "
                         f"{text[pos:pos + 40]!r}")
    return ids, secs
