"""Single-stream host session: incremental audio in, delta text out (port of
nemotron_tpu/streaming/session.py, the same buffering semantics):

  - the mel buffer is primed with pre_encode_cache_size zero frames;
  - a chunk runs while the buffer holds chunk_mel_frames, then the buffer
    advances by shift_mel_frames;
  - each chunk moves the slack-buffer phase on, with `compact_state` at the
    wrap;
  - finalize zero-pads the tail to the chunk width and keeps
    floor(real_new / subsampling_factor) output frames;
  - process_incremental returns only the delta text, finalize only the
    suffix produced by finalization.

The mel frames come from the host-side StreamPreprocessor (kernel B2 on the
card) and go through `ASRModel.stream_step` (kernel B1, or B3 with the
model's attn_block).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..audio.frontend import StreamPreprocessor
from ..models.asr import tokens_to_list
from ..config import CacheConfig, LatencyMode
from .state import (from_numpy, install_slot, state_from_leaves,
                    state_leaves, to_numpy)


def _leaves(obj, prefix=""):
    """{dotted name: tensor} over the dataclass tree of a stream state (the
    decode state and int8 QuantKV caches are dataclasses too)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_leaves(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


class StreamSession:
    def __init__(self, model, cfg: CacheConfig | LatencyMode | int | None = None,
                 lang: str | None = None, timestamp_words: bool = False):
        self.model = model
        # emit {%.2f} inline word timestamps in the incremental text
        self.timestamp_words = timestamp_words
        if cfg is None:
            cfg = model.cache_config(LatencyMode.PURE_CAUSAL)
        elif not isinstance(cfg, CacheConfig):
            cfg = model.cache_config(cfg)
        self.cfg = cfg
        self.hp = model.hp
        self.preprocessor = StreamPreprocessor(
            model.params.preproc.filterbank, model.params.preproc.window)
        self.prompt_index = model.default_prompt_index
        if lang is not None:
            self.set_language(lang)
        self.reset()

    # ------------------------------------------------------------------
    def set_language(self, lang: str) -> bool:
        idx = self.model.resolve_language(lang)
        if idx is None:
            return False
        self.prompt_index = idx
        return True

    def reset(self) -> None:
        self.preprocessor.reset()
        self.state = self.model.init_stream_state(1, self.cfg)
        self.phase = 0  # slack-buffer phase (see models/encoder.py)
        # mel buffer primed with the overlap of zeros
        self.mel_buffer = np.zeros(
            (self.cfg.pre_encode_cache_size, self.hp.n_mels), dtype=np.float32)
        self.tokens: list[int] = []
        self.token_frames: list[int] = []
        self.token_confs: list[float] = []  # a model with confidence only
        self.transcript = ""
        self.total_audio_seconds = 0.0
        self.total_compute_seconds = 0.0
        self.total_chunks = 0
        self._finalized = False

    # ------------------------------------------------------------------
    def _run_chunk(self, mel_chunk: np.ndarray, n_valid: int) -> str:
        model = self.model
        t0 = time.perf_counter()
        frame_base = int(self.state.decode.frame_offset[0])
        # a single stream is always active: the phased fast path
        self.state, tokens = model.stream_step(
            self.cfg, self.state, model.put_batch(mel_chunk[None]),
            model.put_batch(np.asarray([n_valid], np.int32)), None,
            model.put_batch(np.asarray([max(self.prompt_index, 0)], np.int32)),
            phase=self.phase)
        self.phase += 1
        if self.phase >= self.cfg.n_phases:
            self.state = model.compact_state(self.cfg, self.state)
            self.phase = 0
        self.total_chunks += 1
        model.synchronize()
        self.total_compute_seconds += time.perf_counter() - t0
        new = tokens_to_list(
            tokens, vocab_size=self.hp.vocab_size if model.confidence else None,
            with_conf=True)[0]
        if not new:
            return ""
        ids = [tk for tk, _, _ in new]
        frames = [frame_base + fr for _, fr, _ in new]
        self.tokens.extend(ids)
        self.token_frames.extend(frames)
        if new[0][2] is not None:
            self.token_confs.extend(cf for _, _, cf in new)
        text = model.tokenizer.decode(
            ids, timestamp_words=self.timestamp_words, frames=frames)
        self.transcript += text
        return text

    def process_incremental(self, audio_i16) -> str:
        """Feed PCM samples; returns newly decoded text (may be empty)."""
        if self._finalized:
            raise RuntimeError("session already finalized; call reset()")
        audio = np.asarray(audio_i16)
        if audio.size == 0:
            return ""
        self.total_audio_seconds += audio.shape[-1] / self.cfg.sample_rate
        mel = self.preprocessor.process(audio)
        if mel.shape[0]:
            self.mel_buffer = np.concatenate([self.mel_buffer, mel], axis=0)

        chunk_mel = self.cfg.chunk_mel_frames
        shift = self.cfg.shift_mel_frames
        out = []
        while self.mel_buffer.shape[0] >= chunk_mel:
            out.append(self._run_chunk(self.mel_buffer[:chunk_mel],
                                       self.cfg.valid_out_len))
            self.mel_buffer = self.mel_buffer[shift:]
        return "".join(out)

    def finalize(self) -> str:
        """Flush the final partial chunk (zero-padded to the chunk width,
        keeping floor(real_new / subsampling) frames). Returns only the
        text produced by finalization."""
        if self._finalized:
            return ""
        self._finalized = True
        cfg = self.cfg
        total = self.mel_buffer.shape[0]
        if total <= cfg.pre_encode_cache_size:
            return ""
        n_valid = (total - cfg.pre_encode_cache_size) // cfg.subsampling_factor
        if n_valid <= 0:
            return ""
        chunk = np.zeros((cfg.chunk_mel_frames, self.hp.n_mels), np.float32)
        chunk[:total] = self.mel_buffer[:cfg.chunk_mel_frames]
        return self._run_chunk(chunk, n_valid)

    # ------------------------------------------------------------------
    def get_transcript(self) -> str:
        return self.transcript

    def get_tokens(self) -> list[int]:
        return list(self.tokens)

    def rtf(self) -> float:
        """Real-time factor: compute time / audio time."""
        if self.total_audio_seconds <= 0:
            return 0.0
        return self.total_compute_seconds / self.total_audio_seconds

    def save_state(self, path: str) -> None:
        """Checkpoint the whole streaming context (the device state's
        leaves, the host mel and sample buffers, tokens, confidences and
        transcript) so that a dropped stream resumes where it stopped, in
        the JAX package's layout: `n_leaves` and `leaf_{i}` in its pytree
        order (streaming/state.state_leaves), each leaf in its own dtype,
        with its other keys; the port adds `token_confs`. A bf16 leaf is
        written as JAX's np.savez writes an ml_dtypes bfloat16 array, as
        2-byte void records of its bit pattern."""
        leaves = [to_numpy(t) for t in state_leaves(self.state)]
        leaves = [a.view("V2") if a.dtype == np.uint16 else a
                  for a in leaves]  # to_numpy gives bf16 as uint16 bits
        np.savez(
            path, n_leaves=len(leaves),
            **{f"leaf_{i}": a for i, a in enumerate(leaves)},
            mel_buffer=self.mel_buffer,
            pp_buf=self.preprocessor.buf,
            pp_last=np.float32(self.preprocessor.last_sample),
            tokens=np.asarray(self.tokens, dtype=np.int64),
            token_frames=np.asarray(self.token_frames, dtype=np.int64),
            token_confs=np.asarray(self.token_confs, dtype=np.float64),
            transcript=np.frombuffer(self.transcript.encode("utf-8"), np.uint8),
            prompt_index=np.int64(self.prompt_index),
            total_audio_seconds=np.float64(self.total_audio_seconds),
            total_chunks=np.int64(self.total_chunks),
            phase=np.int64(self.phase))

    def restore_state(self, path: str) -> None:
        """Resume from save_state's checkpoint or the JAX package's
        StreamSession.save_state (the state as `leaf_{i}` in its pytree
        order, bf16 leaves as 2-byte records; no confidences there), or
        from the port's earlier layout (`state.<name>` leaves)."""
        z = np.load(path)
        fresh = self.model.init_stream_state(1, self.cfg)
        if "n_leaves" in z.files:  # the JAX package's layout
            dst = state_leaves(fresh)
            n = int(z["n_leaves"])
            if n != len(dst):
                raise ValueError(
                    f"checkpoint has {n} state leaves, this session's state "
                    f"{len(dst)} (mismatched kv-int8 mode?)")
            src = [z[f"leaf_{i}"] for i in range(n)]
            # np.savez keeps an ml_dtypes bfloat16 leaf as void records
            src = [a.view(np.uint16) if a.dtype.kind == "V" else a
                   for a in src]
        else:
            named = _leaves(fresh)
            dst = list(named.values())
            src = [z["state." + name] for name in named]
        confs = ([float(x) for x in z["token_confs"]]
                 if "token_confs" in z.files else [])
        for t, a in zip(dst, src):
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint leaf shape {a.shape} != "
                                 f"{tuple(t.shape)}")
        if "n_leaves" in z.files:  # into the state's own layout (a mesh's)
            install_slot(fresh, 0, state_from_leaves(src, self.model.kv_int8))
        else:
            for t, a in zip(dst, src):
                t.copy_(from_numpy(a, t.dtype))
        self.state = fresh
        self.mel_buffer = z["mel_buffer"]
        self.preprocessor.buf = z["pp_buf"]
        self.preprocessor.last_sample = float(z["pp_last"])
        self.tokens = [int(x) for x in z["tokens"]]
        self.token_frames = [int(x) for x in z["token_frames"]]
        self.token_confs = confs
        self.transcript = bytes(z["transcript"]).decode("utf-8")
        self.prompt_index = int(z["prompt_index"])
        self.total_audio_seconds = float(z["total_audio_seconds"])
        self.total_chunks = int(z["total_chunks"])
        self.phase = int(z["phase"])
        self._finalized = False

    def timed_words(self) -> list[tuple[str, float]]:
        """(word, start_seconds) pairs from emitted tokens (80 ms frames)."""
        return [(w, t) for w, t, _ in self._words(
            [1.0] * len(self.tokens))]

    def timed_words_conf(self) -> list[tuple[str, float, float]]:
        """(word, start_seconds, confidence): the confidence is the minimum
        packed per-token probability over the word's tokens. Needs a model
        built with confidence=True; raises otherwise."""
        if len(self.token_confs) != len(self.tokens):
            raise RuntimeError(
                "per-token confidence was not recorded (build the model "
                "with confidence=True)")
        return self._words(self.token_confs)

    def _words(self, confs) -> list[tuple[str, float, float]]:
        words: list[tuple[str, float, float]] = []
        cur, cur_t, cur_c = "", 0.0, 1.0
        for tid, fr, cf in zip(self.tokens, self.token_frames, confs):
            piece = self.model.tokenizer.piece(tid)
            if piece.startswith("▁"):
                if cur:
                    words.append((cur, cur_t, cur_c))
                cur, cur_t, cur_c = piece[1:], fr * 1280 / 16000, cf
            else:
                cur += piece
                cur_c = min(cur_c, cf)
        if cur:
            words.append((cur, cur_t, cur_c))
        return words
