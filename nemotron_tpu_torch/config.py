"""Model hyperparameters and streaming cache configuration.

TPU-native rebuild of the reference engine's configuration layer:
  - Hparams mirrors the GGUF `nemo.*` header keys (reference: src/nemo-ggml.h:37-55,
    loaded at src/nemo-ggml.cpp:108-142).
  - CacheConfig mirrors the latency-mode math of src/nemo-stream.h:23-128
    (chunk/shift/valid-out formulas), but every derived quantity here is a *static*
    Python int so that one `jax.jit` trace per latency mode covers the whole stream.
"""

from __future__ import annotations

import dataclasses
import os
from enum import IntEnum


@dataclasses.dataclass(frozen=True)
class Hparams:
    """Architecture hyperparameters (static; never traced)."""

    n_mels: int = 128
    d_model: int = 1024
    n_heads: int = 8
    d_head: int = 128
    d_ff: int = 4096
    n_layers: int = 24
    kernel_size: int = 9          # conformer depthwise conv kernel
    vocab_size: int = 1025        # real tokens + blank (last id)
    decoder_dim: int = 640        # prediction-net LSTM hidden size
    joint_dim: int = 640
    subsampling_factor: int = 8
    subsampling_channels: int = 256
    att_left_context: int = 70    # 70 English / 56 multilingual
    num_prompts: int = 0          # 0 = monolingual; 128 = multilingual lang-ID
    eps: float = 1e-5
    max_pos_len: int = 2048       # batch-mode positional table half-length

    @property
    def blank_id(self) -> int:
        return self.vocab_size - 1

    @property
    def decoder_layers(self) -> int:
        return 2

    def subsampled_len(self, t: int) -> int:
        """Output length of the 3x stride-2 causal subsampling stack.

        Each causal stride-2 k=3 conv maps T -> floor(T/2)+1 (pad (k-1, s-1)).
        """
        for _ in range(3):
            t = t // 2 + 1
        return t

    @property
    def subsampled_mels(self) -> int:
        """Frequency width after subsampling (flat-dim component)."""
        f = self.n_mels
        for _ in range(3):
            f = f // 2 + 1
        return f

    @property
    def subsampling_flat_dim(self) -> int:
        # 17 * 256 = 4352 for the 0.6b model
        return self.subsampled_mels * self.subsampling_channels


class LatencyMode(IntEnum):
    """Right-context presets (value == att_right_context)."""

    PURE_CAUSAL = 0   # 80 ms
    ULTRA_LOW = 1     # 160 ms
    LOW = 6           # 560 ms
    DEFAULT = 13      # 1.12 s


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Streaming chunk geometry. All quantities static (compile-time).

    Mirrors src/nemo-stream.h:23-128. A stream consumes `shift_mel_frames` new mel
    frames per chunk, the encoder graph sees `chunk_mel_frames` (9-frame overlap for
    subsampling context), the first `drop_extra_pre_encoded` subsampled frames are
    discarded, and `valid_out_len` encoder frames are decoded.
    """

    att_right_context: int = 0
    att_left_context: int = 70
    cache_drop_size: int = 0
    drop_extra_pre_encoded: int = 2
    pre_encode_cache_size: int = 9
    subsampling_factor: int = 8
    conv_kernel_size: int = 9
    n_mels: int = 128
    sample_rate: int = 16000
    hop_length: int = 160
    # K/V cache slack phases: the cache buffer holds att_left_context +
    # n_phases*chunk_len frames; all-active steps append at a static phase
    # offset (tiny write) and the full 70-frame shift ("compaction") happens
    # once per n_phases chunks instead of every chunk.
    n_phases: int = int(os.environ.get("NEMOTRON_TPU_N_PHASES", "8"))

    @property
    def conv_cache_size(self) -> int:
        return self.conv_kernel_size - 1

    @property
    def chunk_mel_frames(self) -> int:
        # 9 + 8*(1+R):  17 / 25 / 65 / 121
        return self.pre_encode_cache_size + self.subsampling_factor * (
            1 + self.att_right_context
        )

    @property
    def shift_mel_frames(self) -> int:
        # 8*(1+R-drop): frames consumed per chunk
        return self.subsampling_factor * (
            1 + self.att_right_context - self.cache_drop_size
        )

    @property
    def valid_out_len(self) -> int:
        return 1 + self.att_right_context

    @property
    def chunk_samples(self) -> int:
        return self.chunk_mel_frames * self.hop_length

    @property
    def shift_samples(self) -> int:
        return self.shift_mel_frames * self.hop_length

    @property
    def latency_ms(self) -> int:
        return self.chunk_mel_frames * self.hop_length * 1000 // self.sample_rate

    def chunk_len(self, hp: Hparams) -> int:
        """Encoder frames produced per chunk after drop_extra_pre_encoded."""
        return hp.subsampled_len(self.chunk_mel_frames) - self.drop_extra_pre_encoded

    def cache_buf_len(self, hp: Hparams) -> int:
        """Physical K/V buffer length: left context + phase slack."""
        return self.att_left_context + self.n_phases * self.chunk_len(hp)

    def kv_len(self, hp: Hparams) -> int:
        return self.att_left_context + self.chunk_len(hp)

    def pos_len(self, hp: Hparams) -> int:
        return 2 * self.kv_len(hp) - 1

    # Measured per-mode slack-phase sweet spots (PERF.md round-5 sweep,
    # kv-int8, B=768, v5e): small R wants a LONG slack (chunk_len 1 -> tiny
    # tail, rare compaction); at large R the tail n_phases*chunk_len becomes
    # the dominant K/V HBM term — R=13 at n_phases=8 sat past the HBM knee
    # (673 ms/step) vs 169 ms at n_phases=2 (1277 -> 5087 rt streams).
    # NEMOTRON_TPU_N_PHASES always overrides. n_phases also caps the
    # backlog micro-batch depth k (k | n_phases — engine trigger rule).
    _MODE_N_PHASES = {0: 8, 1: 8, 6: 4, 13: 2}

    @staticmethod
    def for_mode(mode: LatencyMode | int, hp: Hparams | None = None) -> "CacheConfig":
        kw = {"att_right_context": int(mode)}
        if "NEMOTRON_TPU_N_PHASES" not in os.environ:
            kw["n_phases"] = CacheConfig._MODE_N_PHASES.get(int(mode), 8)
        if hp is not None:
            kw.update(
                att_left_context=hp.att_left_context,
                conv_kernel_size=hp.kernel_size,
                n_mels=hp.n_mels,
                subsampling_factor=hp.subsampling_factor,
            )
        return CacheConfig(**kw)


MAX_SYMBOLS_PER_STEP = 10  # greedy RNNT per-frame emission bound (nemo-ggml.cpp:1258)
