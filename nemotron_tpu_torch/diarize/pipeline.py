"""Streaming diarization pipeline (port of nemotron_tpu/diarize/pipeline.py):
VAD state machine + speaker embeddings + NME-SC clustering + word
alignment + RTTM / speaker-tagged transcript.

Control flow mirrors src/diarize_pipeline.cpp (rolling audio buffer with
absolute-sample bookkeeping, onset 0.9 / offset 0.5 / 0.6 s hangover, 1.5 s
sub-segments at 0.75 s shift, tail sub-segments >= 0.5 s, word assembly from
ASR fragments, finalize -> cluster -> overlap-resolved timeline -> outputs).

Every advance scores all ready VAD windows in one batched call of the nets
on the params' device (the card unless the caller asks for the CPU), padded
to a power-of-two bucket as the JAX package pads them, and speaker
embeddings batch across sub-segments the same way. On the card each
(net, bucket) is one CUDA graph (the JAX package's jitted nets), kept in
the model's graph cache (`params.graphs`) and shared by its pipelines.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .audio import SPK_WINDOW_SAMPLES, VAD_WINDOW_SAMPLES
from .cluster import NmescConfig, nmesc_cluster
from .nets import spk_embed, vad_probs
from .params import load_diarize_model

SR = 16000
VAD_SHIFT = 160  # 10 ms
EMB_DIM = 192


@dataclasses.dataclass
class VadPostConfig:
    onset: float = 0.9
    offset: float = 0.5
    min_duration_off: float = 0.6
    frame_period_sec: float = 0.01


@dataclasses.dataclass
class Word:
    text: str
    at_sec: float
    speaker: int = -1
    conf: float = -1.0  # min per-token softmax confidence (-1 = unrecorded)


@dataclasses.dataclass
class SpeakerSpan:
    start_sec: float
    end_sec: float
    speaker: int


@dataclasses.dataclass
class DiarizeResult:
    speaker_text: str
    rttm: str
    words: list[Word]
    timeline: list[SpeakerSpan]
    n_speakers: int


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class DiarizePipeline:
    def __init__(self, model_params, num_speakers: int = -1,
                 sub_window_sec: float = 1.5, sub_shift_sec: float = 0.75,
                 min_seg_sec: float = 0.5,
                 vad_post: VadPostConfig | None = None,
                 cluster_cfg: NmescConfig | None = None,
                 max_vad_batch: int = 256,
                 vad_fn=None, spk_fn=None):
        """vad_fn(windows [B, 10080], lens [B]) -> [B] probs and
        spk_fn(windows [B, 24000], lens [B]) -> [B, 192] override the model
        (dependency injection for tests)."""
        self.params = model_params
        self._vad_fn = vad_fn or (lambda w, l: self._run(vad_probs, "vad",
                                                         w, l))
        self._spk_fn = spk_fn or (lambda w, l: self._run(spk_embed, "spk",
                                                         w, l))
        self.vad_post = vad_post or VadPostConfig()
        self.cluster_cfg = cluster_cfg or NmescConfig()
        if num_speakers > 0:
            self.cluster_cfg.oracle_num_speakers = num_speakers
        self.sub_window_samp = int(round(sub_window_sec * SR))
        self.sub_shift_samp = int(round(sub_shift_sec * SR))
        self.min_seg_samp = int(round(min_seg_sec * SR))
        self.max_vad_batch = max_vad_batch

        self.min_off_frames = int(np.ceil(
            self.vad_post.min_duration_off / self.vad_post.frame_period_sec))

        # rolling audio buffer: audio_buf[k] is absolute sample dropped + k
        self.audio_buf = np.zeros(0, np.float32)
        self.dropped = 0
        self.total_samples = 0

        self.vad_next_frame = 0
        # frames scored so far (a long-lived server stream scores one frame
        # per 10 ms forever — keep a counter, not an unbounded list)
        self.n_vad_frames = 0

        self.in_speech = False
        self.n_off_run = 0
        self.open_seg_start_frame = -1
        self.open_seg_id = -1
        self.next_seg_id = 0
        self.open_next_subseg = 0

        self.segments: list[tuple[int, float, float]] = []
        # sub-segments: (seg_id, start_sec, end_sec); embeddings parallel array
        self.subs: list[tuple[int, float, float]] = []
        self.embs: list[np.ndarray] = []
        self._pending_spk: list[tuple[int, float, float, int, int]] = []
        # (seg_id, start_sec, end_sec, abs_sample, lens)

        self.words: list[Word] = []
        self.json_drained = 0
        self.word_pending = ""
        self.word_pending_at = 0.0
        self.word_pending_conf = -1.0
        self._finalized = False

    @classmethod
    def from_gguf(cls, path: str, num_speakers: int = -1,
                  sub_shift_ms: int = 750, device="cuda",
                  **kw) -> "DiarizePipeline":
        params = load_diarize_model(path, device=device)
        return cls(params, num_speakers=num_speakers,
                   sub_shift_sec=sub_shift_ms / 1000.0, **kw)

    def _run(self, net, name: str, windows: np.ndarray,
             lens: np.ndarray) -> np.ndarray:
        """One batched call of a net on the params' device: one graph per
        (net, bucket) on the card (graphs.py), its output copied to the
        host at once (the key's next replay overwrites it)."""
        dev = self.params.device
        weights = getattr(self.params, name)
        out, = self.params.graphs.run(
            (name, len(windows)), 0, dev,
            lambda _state, w, n: (net(weights, w, n),), (),
            (torch.from_numpy(np.ascontiguousarray(windows)).to(dev),
             torch.from_numpy(np.ascontiguousarray(lens)).to(dev)))
        return out.cpu().numpy()

    # ------------------------------------------------------------------
    def _audio_at(self, abs_sample: int, n: int) -> np.ndarray | None:
        k = abs_sample - self.dropped
        if k < 0 or k + n > len(self.audio_buf):
            return None
        return self.audio_buf[k : k + n]

    def _has_through(self, abs_end: int) -> bool:
        return abs_end <= self.dropped + len(self.audio_buf)

    def _drop_before(self, abs_sample: int) -> None:
        if abs_sample <= self.dropped:
            return
        n = min(abs_sample - self.dropped, len(self.audio_buf))
        if n > 0:
            self.audio_buf = self.audio_buf[n:]
            self.dropped += n

    # ------------------------------------------------------------------
    def _batched_vad(self, n_windows: int) -> np.ndarray:
        """Score n_windows consecutive VAD windows starting at vad_next_frame."""
        start = self.vad_next_frame * VAD_SHIFT - self.dropped
        sw = self.audio_buf.strides[0]
        view = np.lib.stride_tricks.as_strided(
            self.audio_buf[start:],
            shape=(n_windows, VAD_WINDOW_SAMPLES),
            strides=(VAD_SHIFT * sw, sw), writeable=False)
        b = _bucket(n_windows)
        wins = np.zeros((b, VAD_WINDOW_SAMPLES), np.float32)
        wins[:n_windows] = view
        lens = np.full(b, VAD_WINDOW_SAMPLES, np.int32)
        return np.asarray(self._vad_fn(wins, lens))[:n_windows]

    def _queue_subseg(self, abs_sample: int, lens: int) -> None:
        real = min(lens, SPK_WINDOW_SAMPLES)
        self._pending_spk.append((
            self.open_seg_id,
            abs_sample / SR,
            (abs_sample + real) / SR,
            abs_sample,
            real,
        ))
        self.open_next_subseg += 1

    def _flush_spk(self) -> None:
        """Embed all queued sub-segments in one batched call."""
        if not self._pending_spk:
            return
        n = len(self._pending_spk)
        b = _bucket(n)
        wins = np.zeros((b, SPK_WINDOW_SAMPLES), np.float32)
        lens = np.full(b, SPK_WINDOW_SAMPLES, np.int32)
        for i, (_sid, _s, _e, abs_sample, real) in enumerate(self._pending_spk):
            src = self._audio_at(abs_sample, real)
            if src is not None:
                wins[i, :real] = src
            lens[i] = max(1, real)
        embs = np.asarray(self._spk_fn(wins, lens))
        for i, (sid, s_sec, e_sec, _a, _r) in enumerate(self._pending_spk):
            e = embs[i]
            e = e / (np.sqrt((e ** 2).sum()) + 1e-8)  # L2 normalize
            self.subs.append((sid, s_sec, e_sec))
            self.embs.append(e.astype(np.float32))
        self._pending_spk.clear()

    def _close_segment(self, end_frame: int) -> None:
        if not self.in_speech:
            return
        self.segments.append((
            self.open_seg_id,
            self.open_seg_start_frame * 0.01,
            end_frame * 0.01,
        ))
        self.in_speech = False
        self.open_seg_id = -1
        self.open_seg_start_frame = -1
        self.open_next_subseg = 0
        self.n_off_run = 0

    def _advance(self) -> None:
        while True:
            avail_end = self.dropped + len(self.audio_buf)
            first_start = self.vad_next_frame * VAD_SHIFT
            n_ready = (avail_end - first_start - VAD_WINDOW_SAMPLES) // VAD_SHIFT + 1
            if n_ready <= 0:
                break
            n_ready = min(n_ready, self.max_vad_batch)
            probs = self._batched_vad(n_ready)

            for prob in probs:
                self.n_vad_frames += 1
                f = self.vad_next_frame
                if not self.in_speech:
                    if prob >= self.vad_post.onset:
                        self.in_speech = True
                        self.open_seg_id = self.next_seg_id
                        self.next_seg_id += 1
                        self.open_seg_start_frame = f
                        self.open_next_subseg = 0
                        self.n_off_run = 0
                else:
                    if prob < self.vad_post.offset:
                        self.n_off_run += 1
                        if self.n_off_run >= self.min_off_frames:
                            end_frame = max(f + 1 - self.n_off_run,
                                            self.open_seg_start_frame)
                            seg_start = self.open_seg_start_frame * VAD_SHIFT
                            seg_end = end_frame * VAD_SHIFT
                            covered = seg_start + (
                                (self.open_next_subseg - 1) * self.sub_shift_samp
                                + self.sub_window_samp
                                if self.open_next_subseg > 0 else 0)
                            leftover = seg_end - covered
                            if (leftover >= self.min_seg_samp
                                    and self.open_next_subseg > 0):
                                self._queue_subseg(covered, leftover)
                            elif (self.open_next_subseg == 0
                                  and seg_end - seg_start >= self.min_seg_samp):
                                self._queue_subseg(seg_start, seg_end - seg_start)
                            self._close_segment(end_frame)
                    else:
                        self.n_off_run = 0

                self.vad_next_frame += 1

                if self.in_speech:
                    seg_start = self.open_seg_start_frame * VAD_SHIFT
                    while True:
                        s = seg_start + self.open_next_subseg * self.sub_shift_samp
                        if not self._has_through(s + self.sub_window_samp):
                            break
                        self._queue_subseg(s, self.sub_window_samp)

        # embed what we queued before dropping their audio
        self._flush_spk()

        drop_to = self.vad_next_frame * VAD_SHIFT
        if self.in_speech:
            seg_start = self.open_seg_start_frame * VAD_SHIFT
            drop_to = min(
                drop_to, seg_start + self.open_next_subseg * self.sub_shift_samp
            )
        self._drop_before(drop_to)

    # ------------------------------------------------------------------
    def push_audio(self, audio_f32) -> int:
        audio = np.asarray(audio_f32, np.float32)
        if audio.size == 0:
            return 0
        self.audio_buf = np.concatenate([self.audio_buf, audio])
        self.total_samples += len(audio)
        before = self.n_vad_frames
        self._advance()
        return self.n_vad_frames - before

    def push_text(self, text: str, at_sec: float,
                  conf: float = -1.0) -> None:
        for c in text:
            if c in " \t\n\r":
                if self.word_pending:
                    self.words.append(Word(self.word_pending,
                                           self.word_pending_at,
                                           conf=self.word_pending_conf))
                    self.word_pending = ""
                    self.word_pending_conf = -1.0
            else:
                self.word_pending += c
                self.word_pending_at = at_sec
                if conf >= 0.0:
                    self.word_pending_conf = (
                        conf if self.word_pending_conf < 0.0
                        else min(self.word_pending_conf, conf))

    def drain_json(self) -> list[str]:
        out = []
        for w in self.words[self.json_drained :]:
            rec = {"word": w.text, "at": round(w.at_sec, 3)}
            if w.conf >= 0.0:
                rec["conf"] = round(w.conf, 3)
            out.append(json.dumps(rec))
        self.json_drained = len(self.words)
        return out

    # ------------------------------------------------------------------
    def _finalize_open_segment(self) -> None:
        if not self.in_speech:
            return
        end_frame = self.vad_next_frame
        seg_start = self.open_seg_start_frame * VAD_SHIFT
        seg_end = min(end_frame * VAD_SHIFT, self.total_samples)
        covered = seg_start + (
            (self.open_next_subseg - 1) * self.sub_shift_samp
            + self.sub_window_samp if self.open_next_subseg > 0 else 0)
        leftover = seg_end - covered
        if leftover >= self.min_seg_samp:
            self._queue_subseg(covered, leftover)
        elif (self.open_next_subseg == 0
              and seg_end - seg_start >= self.min_seg_samp):
            self._queue_subseg(seg_start, seg_end - seg_start)
        self._flush_spk()
        self._close_segment(end_frame)

    def finalize_embeddings(self) -> None:
        """Device half of finalize: flush the open segment's tail
        sub-segments through TitaNet and the pending word. After this call
        no device math remains — finalize_cluster() is pure host/CPU work
        and may run on another thread (the server takes NME-SC off the
        engine-tick critical path this way: a 1+ s cluster at N=512 on the
        tick thread would stall every stream's 80 ms deadline)."""
        if self._finalized:
            return
        self._finalized = True
        self._finalize_open_segment()
        if self.word_pending:
            self.words.append(Word(self.word_pending, self.word_pending_at,
                                   conf=self.word_pending_conf))
            self.word_pending = ""

    def finalize(self) -> DiarizeResult:
        if self._finalized:
            return DiarizeResult("", "", self.words, [], 0)
        self.finalize_embeddings()
        return self.finalize_cluster()

    def finalize_cluster(self) -> DiarizeResult:
        """Clustering + word alignment + outputs (host numpy; the NME-SC
        eigendecomposition runs on the CPU in cluster.py). Call after
        finalize_embeddings()."""
        if not self.subs:
            return DiarizeResult("", "", self.words, [], 0)

        embs = np.stack(self.embs)
        res = nmesc_cluster(embs, self.cluster_cfg)
        timeline = build_speaker_timeline(self.subs, res.labels)

        for w in self.words:
            w.speaker = speaker_at(timeline, w.at_sec)

        # speaker-tagged transcript (format: transcribe_stream + reference)
        lines = []
        cur_spk = None
        cur_words: list[str] = []
        for w in self.words:
            if w.speaker != cur_spk:
                if cur_spk is not None:
                    lines.append(f"[spk_{cur_spk if cur_spk >= 0 else -1}] "
                                 + " ".join(cur_words) + " ")
                cur_spk = w.speaker
                cur_words = []
            cur_words.append(w.text)
        if cur_spk is not None:
            lines.append(f"[spk_{cur_spk if cur_spk >= 0 else -1}] "
                         + " ".join(cur_words) + " ")
        speaker_text = "\n".join(lines) + ("\n" if lines else "")

        rttm_lines = []
        for sp in timeline:
            if sp.speaker < 0:
                continue
            rttm_lines.append(
                f"SPEAKER session 1 {sp.start_sec:g} "
                f"{sp.end_sec - sp.start_sec:g} <NA> <NA> "
                f"spk_{sp.speaker} <NA> <NA>")
        rttm = "\n".join(rttm_lines) + ("\n" if rttm_lines else "")

        return DiarizeResult(speaker_text, rttm, self.words, timeline,
                             res.est_num_speakers)

    # introspection (reference: diarize_pipeline.cpp:504-506)
    @property
    def n_embeddings(self) -> int:
        return len(self.embs)

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def n_words(self) -> int:
        return len(self.words)


def build_speaker_timeline(subs, labels) -> list[SpeakerSpan]:
    """Merge same-speaker overlaps, split different-speaker overlaps at the
    midpoint (reference: diarize_pipeline.cpp:372-421)."""
    if not subs:
        return []
    raw = sorted(
        (SpeakerSpan(s[1], s[2], int(labels[i])) for i, s in enumerate(subs)),
        key=lambda sp: sp.start_sec,
    )
    merged: list[SpeakerSpan] = []
    for s in raw:
        s = SpeakerSpan(s.start_sec, s.end_sec, s.speaker)
        if merged:
            prev = merged[-1]
            if prev.speaker == s.speaker and s.start_sec <= prev.end_sec + 1e-3:
                prev.end_sec = max(prev.end_sec, s.end_sec)
                continue
            if s.start_sec < prev.end_sec:
                mid = 0.5 * (s.start_sec + prev.end_sec)
                prev.end_sec = mid
                s.start_sec = mid
        merged.append(s)
    return merged


def speaker_at(timeline: list[SpeakerSpan], t: float) -> int:
    """Binary search the last span starting <= t (diarize_pipeline.cpp:423-435)."""
    lo, hi, best = 0, len(timeline) - 1, -1
    while lo <= hi:
        mid = (lo + hi) // 2
        if timeline[mid].start_sec <= t:
            best = mid
            lo = mid + 1
        else:
            hi = mid - 1
    if best < 0 or t > timeline[best].end_sec:
        return -1
    return timeline[best].speaker


@dataclasses.dataclass
class VadSegment:
    start_sec: float
    end_sec: float


def vad_extract_segments(speech_probs, onset=0.5, offset=0.5, pad_onset=0.0,
                         pad_offset=0.0, min_duration_on=0.0,
                         min_duration_off=0.0, frame_period_sec=0.01):
    """Offline threshold-based segment extraction from a VAD probability
    stream (reference: vad_extract_segments, diarize_vad.cpp:507-563)."""
    probs = np.asarray(speech_probs, np.float32)
    fp = frame_period_sec
    min_on = int(np.ceil(min_duration_on / fp))
    min_off = int(np.ceil(min_duration_off / fp))

    out: list[VadSegment] = []
    in_seg = False
    seg_start = -1
    for t, p in enumerate(probs):
        if not in_seg:
            if p >= onset:
                in_seg = True
                seg_start = t
        elif p < offset:
            if t - seg_start >= min_on:
                out.append(VadSegment(seg_start * fp - pad_onset,
                                      t * fp + pad_offset))
            in_seg = False
    if in_seg and len(probs) - seg_start >= min_on:
        out.append(VadSegment(seg_start * fp - pad_onset,
                              len(probs) * fp + pad_offset))

    if min_off > 0 and len(out) >= 2:
        merged = [out[0]]
        for seg in out[1:]:
            if (seg.start_sec - merged[-1].end_sec) / fp < min_off:
                merged[-1].end_sec = seg.end_sec
            else:
                merged.append(seg)
        out = merged

    for seg in out:
        seg.start_sec = max(0.0, seg.start_sec)
        seg.end_sec = max(seg.start_sec, seg.end_sec)
    return out
