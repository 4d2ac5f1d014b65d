"""Per-stream device-resident state for cache-aware streaming (port of
nemotron_tpu/streaming/state.py): the same fields, layouts and phase
semantics, so the two packages' states compare leaf by leaf."""

from __future__ import annotations

import dataclasses

import torch

from ..models.decoder import DecodeState, init_decode_state
from ..ops.kvquant import kv_parts, kv_zeros
from ..shared.config import CacheConfig, Hparams

# Steady-state preprocessor tail: with the carry primed as [256 centre-pad
# zeros || first 96 pre-emphasized samples], every shift_samples block
# yields exactly shift_mel_frames mel frames.
PP_TAIL_LEN = 512 - 160  # n_fft - hop


@dataclasses.dataclass
class StreamState:
    k_cache: torch.Tensor      # [L, B, H, cache_buf_len, Dh] head-major
    v_cache: torch.Tensor      # ... or ops.kvquant.QuantKV (kv_int8)
    conv_cache: torch.Tensor   # [L, B, kernel-1, D]
    cache_valid: torch.Tensor  # [B] int32
    decode: DecodeState
    pp_tail: torch.Tensor      # [B, PP_TAIL_LEN] f32 pre-emphasized carry
    pp_last: torch.Tensor      # [B] f32 raw last sample
    mel_ov: torch.Tensor       # [B, pre_encode_cache_size, n_mels] f32


def init_stream_state(batch: int, hp: Hparams, cfg: CacheConfig,
                      dtype=torch.float32, device="cpu",
                      kv_int8: bool = False) -> StreamState:
    """Zero state; kv_int8 allocates int8 QuantKV K/V caches."""
    L, D = hp.n_layers, hp.d_model
    kv_shape = (L, batch, hp.n_heads, cfg.cache_buf_len(hp), hp.d_head)
    f32 = dict(dtype=torch.float32, device=device)

    def kv():
        if kv_int8:
            return kv_zeros(kv_shape, device=device)
        return torch.zeros(kv_shape, dtype=dtype, device=device)

    return StreamState(
        k_cache=kv(),
        v_cache=kv(),
        conv_cache=torch.zeros((L, batch, cfg.conv_kernel_size - 1, D),
                               dtype=dtype, device=device),
        cache_valid=torch.zeros((batch,), dtype=torch.int32, device=device),
        decode=init_decode_state(batch, hp, dtype=dtype, device=device),
        pp_tail=torch.zeros((batch, PP_TAIL_LEN), **f32),
        pp_last=torch.zeros((batch,), **f32),
        mel_ov=torch.zeros((batch, cfg.pre_encode_cache_size, cfg.n_mels),
                           **f32),
    )


def reset_slots(state: StreamState, mask, hp: Hparams) -> StreamState:
    """Zero the slots where mask[b] is True (stream join), in place."""
    rows = torch.nonzero(torch.as_tensor(mask, device=state.cache_valid.device)
                         ).flatten()
    for buf in (*kv_parts(state.k_cache), *kv_parts(state.v_cache),
                state.conv_cache):
        buf[:, rows] = 0
    for buf in (state.cache_valid, state.decode.h, state.decode.c,
                state.decode.frame_offset, state.pp_tail, state.pp_last,
                state.mel_ov):
        buf[rows] = 0
    state.decode.prev_token[rows] = hp.blank_id
    return state


def prime_frontend(state: StreamState, mask, tails, lasts) -> StreamState:
    """Install per-slot frontend carries (slot join: tail = 256 centre-pad
    zeros + the stream's first 96 pre-emphasized samples, so every later
    shift_samples block yields exactly shift_mel_frames frames)."""
    m = mask.to(torch.bool)
    return dataclasses.replace(
        state,
        pp_tail=torch.where(m[:, None], tails, state.pp_tail),
        pp_last=torch.where(m, lasts, state.pp_last),
    )

