"""Model handle for the streaming engine (port of the serving surface of
nemotron_tpu/api.py:ASRModel).

The model lives on an explicit `device`. Its encoder matrices may be
weight-only quantized (Q8_0 / Q4_0, `from_gguf(keep_quantized=True)` or
`params.quantize_encoder_layers`), and `kv_int8` gives its streams int8 K/V
caches. Float32 numerics are pinned: the
port turns TF32 off for matmuls and for cuDNN convolutions (cuDNN runs f32
convolutions in TF32 by default, which alone would move the subsampling
output by ~1e-3 against the JAX package).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import asr
from .models.encoder import compact_cache, realign_cache
from .params import ModelParams, load_model, random_params
from .shared.config import CacheConfig, Hparams, LatencyMode
from .shared.tokenizer import Tokenizer
from .streaming import state as state_mod

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Multilingual default prompt index 101 = "auto".
DEFAULT_PROMPT_INDEX = 101


class ASRModel:
    def __init__(self, hp: Hparams, params: ModelParams,
                 vocab: list[str] | None = None,
                 prompt_dict: dict[str, int] | None = None,
                 device="cpu", kv_int8: bool = False):
        self.hp = hp
        self.params = params
        self.device = torch.device(device)
        self.kv_int8 = kv_int8  # int8 QuantKV attention caches
        self.tokenizer = Tokenizer(vocab or [])
        self.prompt_dict = prompt_dict or {}
        self.default_prompt_index = (
            DEFAULT_PROMPT_INDEX if hp.num_prompts > 0 else -1)
        if hp.num_prompts > 0 and self.default_prompt_index >= hp.num_prompts:
            self.default_prompt_index = 0

    @classmethod
    def from_gguf(cls, path: str, dtype=torch.float32, device="cpu",
                  keep_quantized: bool = False, kv_int8: bool = False):
        hp, params, meta = load_model(path, dtype=dtype, device=device,
                                      keep_quantized=keep_quantized)
        return cls(hp, params, meta["vocab"], meta["prompt_dict"], device,
                   kv_int8=kv_int8)

    @classmethod
    def random(cls, hp: Hparams | None = None, seed: int = 0,
               dtype=torch.float32, device="cpu", kv_int8: bool = False):
        hp = hp or Hparams()
        vocab = [("▁w%d" % i) if i % 2 == 0 else ("p%d" % i)
                 for i in range(hp.vocab_size - 1)]
        return cls(hp, random_params(hp, seed=seed, dtype=dtype,
                                     device=device), vocab, device=device,
                   kv_int8=kv_int8)

    def cache_config(self, mode: LatencyMode | int = LatencyMode.PURE_CAUSAL):
        return CacheConfig.for_mode(mode, self.hp)

    @property
    def backend_name(self) -> str:
        return f"{self.device.type}:{self.device.index or 0}"

    def resolve_language(self, lang: str) -> int | None:
        if self.hp.num_prompts <= 0:
            return None
        return self.prompt_dict.get(lang)

    def put_batch(self, arr) -> torch.Tensor:
        """Host array -> a tensor on the model's device (always a copy)."""
        return torch.tensor(np.asarray(arr), device=self.device)

    def init_stream_state(self, batch: int, cfg: CacheConfig):
        # the activation type, read from a leaf that is never quantized
        return state_mod.init_stream_state(
            batch, self.hp, cfg, dtype=self.params.pos_emb.dtype,
            device=self.device, kv_int8=self.kv_int8)

    @staticmethod
    def pack_tick_inputs(audio_block, n_valid, prompt_idx, active):
        """Host-side packing for fused_tick_packed: [B, k*shift+3] int16
        (audio | n_valid | prompt | active): one upload per tick."""
        b = audio_block.shape[0]
        cols = np.empty((b, 3), dtype=np.int16)
        cols[:, 0] = n_valid
        cols[:, 1] = prompt_idx if prompt_idx is not None else 0
        cols[:, 2] = active if active is not None else 1
        return np.concatenate([audio_block, cols], axis=1)

    def fused_tick_packed(self, cfg, state, packed_dev, all_active: bool,
                          phase: int = 0, k: int = 1,
                          fast_gated: bool = False):
        """One fused tick on a packed input (see pack_tick_inputs). The
        state's caches are updated in place. k > 1 (all-active only)
        advances every stream by k chunks, wrap compaction included; the
        caller's phase then advances by k mod n_phases. A partially active
        batch runs the masked fast path (fast_gated): the engine realigns
        paused slots on resume."""
        if k > 1 and not all_active:
            raise ValueError("multi-chunk ticks are all-active only")
        if not all_active and not fast_gated:
            raise NotImplementedError(
                "the phase-stationary gated tick is not ported; use the "
                "masked fast path (fast_gated=True)")
        hp = self.hp
        shift = cfg.shift_samples
        audio = packed_dev[:, :k * shift]
        n_valid = packed_dev[:, k * shift].to(torch.int32)
        prompt = (packed_dev[:, k * shift + 1].to(torch.int32)
                  if hp.num_prompts > 0 else None)
        if k > 1:
            return asr.fused_serve_tick_scan(
                self.params, state, audio, n_valid, prompt, hp=hp, cfg=cfg,
                k=k, phase=phase)
        act = None if all_active else packed_dev[:, k * shift + 2] != 0
        return asr.fused_serve_tick(
            self.params, state, audio, n_valid, act, prompt, hp=hp, cfg=cfg,
            phase=phase)

    def prime_frontend(self, state, mask, tails, lasts):
        """Install frontend carries for newly joined slots."""
        return state_mod.prime_frontend(state, self.put_batch(mask),
                                        self.put_batch(tails),
                                        self.put_batch(lasts))

    def compact_state(self, cfg, state, phase: int | None = None, mask=None):
        """Move the live K/V window back to phase 0 (in place). `phase` is
        the caller's CURRENT phase (default: the wrap); `mask` restricts the
        compaction to those slots."""
        if phase is None:
            phase = cfg.n_phases
        if phase == 0:
            return state
        k, v = compact_cache(cfg, self.hp, state.k_cache, state.v_cache,
                             phase=phase,
                             mask=None if mask is None else self.put_batch(mask))
        return dataclasses.replace(state, k_cache=k, v_cache=v)

    def realign_state(self, cfg, state, delta: int, mask):
        """Move masked slots' K/V windows forward by `delta` phases."""
        k, v = realign_cache(cfg, self.hp, state.k_cache, state.v_cache,
                             delta, self.put_batch(mask))
        return dataclasses.replace(state, k_cache=k, v_cache=v)

    def synchronize(self) -> None:
        """Wait for the device's queued work (block_until_ready)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
