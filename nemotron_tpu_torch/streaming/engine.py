"""Batched multi-stream engine (port of nemotron_tpu/streaming/engine.py).

All streams of one latency mode (right context 0, 1, 6 or 13) are slots of
one device-resident state batch, an `EngineGroup`; streams of different
modes share the engine as separate groups. Each group's tick uploads one
packed raw-PCM block and runs ONE fused tick (mel frontend + cached
encoder + greedy RNNT) for every ready slot. Token
readbacks are pipelined: a tick's tokens start copying to pinned host memory
right after dispatch and are scattered on a later tick, after the next step
has been queued.

Threading contract (as the JAX engine): `tick()` runs on the engine thread,
which owns every device mutation, while the server's event loop calls
claim / push_audio / end_stream / drop / request_export / request_import.
claim only queues a slot reset, push_audio appends to a queue that tick
drains with an atomic list swap, and drops, exports and imports are
applied at the top of the next tick. (The JAX engine's DEVICE_LOCK guards
a hazard of its TPU runtime and has no counterpart here.)

Ported: start, push, end and drop; the all-active tick; the masked fast
tick with realign-on-resume; wrap compaction (masked when slots are paused
mid-cycle); finalize with reduced n_valid; the k-chunk backlog tick; the
readback FIFO (steps only: an end with no row left to finalize waits on
the newest step in flight, where the JAX engine queues a sentinel that
counts toward its depth); transcript and stats; events with their decode
position (`at_sec`) and minimum token confidence (`conf`, a model built
with confidence=True); live-stream migration (`request_export` /
`request_import`, `snapshot_to_bytes` / `snapshot_from_bytes` in the JAX
package's byte format); and the legacy flow (`gated_realign=False`: a
tick with paused slots compacts to phase 0 and runs the phase-stationary
gated tick) with its phase timers (`phase_timers=True`: the encoder and
decoder halves timed apart, `encoder_seconds` / `decoder_seconds` in
stats); the readback depth and the k-chunk cap (`readback_depth`,
`max_tick_chunks`); and the native ingest source (`source=`, a
serving/ingest.NativeIngest: PCM stages in the C++ layer's rings, and each
tick takes its whole block with one call). The JAX package reads the flow,
the timers, the depth and the cap from NEMOTRON_TPU_GATED_REALIGN,
NEMOTRON_TPU_PHASE_TIMERS, NEMOTRON_TPU_READBACK_DEPTH and
NEMOTRON_TPU_MAX_TICK_CHUNKS; here they are arguments, and the server maps
the variables onto them.

Each group times its tick's phases as spans of its own table (`spans`,
utils/trace.py): one `engine.tick` root a tick, and under it
`engine.admin`, `.ingest`, `.prime`, `.scan`, `.take`, `.step` (a tick
that dispatches: `.slot_ops`, `.pack`, `.upload`, `.dispatch` with
`.encoder` and `.decoder` under phase_timers, and the readbacks due),
`.readback_wait` and `.scatter` (one pair a readback collected; the wait
counts `same_tick` where it collects the step its own tick dispatched)
and `.more`. `stats()` reads the table; under a torch.profiler session the
spans are also `nt:` events of the trace.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import itertools
import threading
import time

import numpy as np
import torch

from ..graphs import SLOT_KEYS
from ..models.decoder import unpack_tokens
from ..ops.kvquant import QuantKV, is_quant
from ..streaming.state import (PP_TAIL_LEN, extract_slots, install_slot,
                               state_from_leaves, state_leaves)
from ..utils.trace import Totals

def _group_key(g, key) -> bool:
    """Whether graph `key` is one of group g's: a tick key names its cfg
    and batch (the decode half's after a flag), a slot operation's key its
    cfg (graphs.SLOT_KEYS)."""
    return ((g.cfg, g.batch) in (key[1:3], key[2:4])
            or (key[0] in SLOT_KEYS and key[1] == g.cfg))


# The default of EngineGroup's readback_depth: a step is collected when
# more than this many dispatched steps are in flight. At any depth >= 1 a
# step is collected once a newer one is dispatched anyway, so the depth
# bounds nothing further.
READBACK_DEPTH = 2

# Backlog micro-batching: when every slot is occupied, steady and has this
# many chunks staged, one tick advances every stream by k chunks (the default
# of EngineGroup's max_tick_chunks). Clamped to the largest divisor of
# n_phases (the k-chunk tick's phase contract).
MAX_TICK_CHUNKS = 8

# Samples folded into the frontend carry at stream start: the carry becomes
# [256 centre-pad zeros || preemph(first 96 samples)], after which every
# shift_samples block yields exactly shift_mel_frames frames.
PRIME_SAMPLES = PP_TAIL_LEN - 256  # 96
PREEMPH = 0.97


def max_safe_tick_chunks(n_phases: int,
                         max_chunks: int = MAX_TICK_CHUNKS) -> int:
    k = min(max_chunks, n_phases)
    while n_phases % k:
        k -= 1
    return max(1, k)


def prime_carry(raw: np.ndarray) -> tuple[np.ndarray, float]:
    """A stream's first PRIME_SAMPLES int16 samples -> (pp_tail [PP_TAIL_LEN]
    f32, pp_last). Pre-emphasis with a zero carry except that sample 0 passes
    through (start-of-stream semantics of the reference preprocessor)."""
    x = raw.astype(np.float32) / np.float32(32768.0)
    emph = np.empty_like(x)
    emph[0] = x[0]
    emph[1:] = x[1:] - np.float32(PREEMPH) * x[:-1]
    tail = np.zeros(PP_TAIL_LEN, np.float32)
    tail[PP_TAIL_LEN - len(x):] = emph
    return tail, float(x[-1])


@dataclasses.dataclass
class _Pending:
    """One entry of the FIFO readback queue: a dispatched step's tokens,
    and the streams that ended with no row left to finalize while it was
    the newest step in flight (their `ended` events follow its scatter, so
    none overtakes its stream's last in-flight tokens)."""

    tokens_host: object = None  # CPU tensor being filled by an async copy
    ready: object = None        # torch.cuda.Event recorded after the copy
    result: object = None
    active: object = None
    n_valid: object = None
    finalizing: object = None
    frame_base: object = None
    stream_ids: object = None
    ends: list = dataclasses.field(default_factory=list)  # (slot, stream)
    tick: int = 0  # the group's tick that dispatched the step
    t_dispatch: float = 0.0


@dataclasses.dataclass
class Event:
    stream_id: int
    kind: str  # "text" | "ended"
    text: str
    # decode position of the emitting step in stream seconds: the end of
    # its valid subsampled-frame window; -1.0 where unknown (an "ended"
    # sentinel with no text)
    at_sec: float = -1.0
    # minimum per-token confidence over the event's tokens (a model built
    # with confidence=True), else -1.0
    conf: float = -1.0


class _Slot:
    __slots__ = (
        "stream_id", "tokens", "token_frames", "transcript", "prompt_index",
        "ending", "finalize_sent", "audio_queue", "stage", "staged",
        "primed", "total_pushed", "steps",
    )

    def __init__(self, stream_id: int, prompt_index: int):
        self.stream_id = stream_id
        self.tokens: list[int] = []
        self.token_frames: list[int] = []
        self.transcript = ""
        self.prompt_index = prompt_index
        self.ending = False
        self.finalize_sent = False
        self.audio_queue: list[np.ndarray] = []  # filled cross-thread
        self.stage: list[np.ndarray] = []        # tick-owned sample buffer
        self.staged = 0
        self.primed = False
        self.total_pushed = 0
        self.steps = 0

    def take(self, n: int) -> np.ndarray:
        """Pop up to n samples from the stage (i16), zero-padded to n."""
        out = np.zeros(n, dtype=np.int16)
        got = 0
        while self.stage and got < n:
            a = self.stage[0]
            k = min(len(a), n - got)
            out[got:got + k] = a[:k]
            got += k
            if k == len(a):
                self.stage.pop(0)
            else:
                self.stage[0] = a[k:]
        self.staged -= got
        return out


class EngineGroup:
    """All streams of one latency mode, stepped as one batch.

    gated_realign (default) rides every tick with paused slots on the masked
    fast path and realigns a paused slot's window on resume; False is the
    legacy flow: such a tick first compacts the window back to phase 0 and
    runs the phase-stationary gated tick there. phase_timers times the
    encoder and decoder halves of each tick apart (api.fused_tick_profiled)
    and forces the legacy flow and single-chunk ticks, as the JAX
    package's PHASE_TIMERS does. readback_depth and max_tick_chunks are
    the JAX engine's READBACK_DEPTH and MAX_TICK_CHUNKS, clamped to >= 1 as
    there; the depth counts dispatched steps in flight, never the `ended`
    events waiting on them (the JAX engine counts those too), so it bounds
    nothing beyond collecting a step once a newer one is dispatched.

    `source` (optional) is a native ingest backend (serving/ingest.py): PCM
    then stages in its C++ rings instead of the slots' Python lists, and
    the tick pulls it with ONE take_block call. The admission budget is
    released natively at take time, so consumed_samples stays empty."""

    def __init__(self, model, cfg, batch: int, gated_realign: bool = True,
                 phase_timers: bool = False,
                 readback_depth: int = READBACK_DEPTH,
                 max_tick_chunks: int = MAX_TICK_CHUNKS, source=None):
        self.model = model
        self.cfg = cfg
        self.batch = batch
        self.hp = model.hp
        self.source = source
        self.readback_depth = max(1, int(readback_depth))
        self.max_tick_chunks = max(1, int(max_tick_chunks))
        self.phase_timers = phase_timers
        self.use_realign = gated_realign and not phase_timers
        self.state = model.init_stream_state(batch, cfg)
        self.slots: list[_Slot | None] = [None] * batch
        self.n_active_streams = 0
        # host mirror of each slot's decode frame offset
        self.frame_offsets = np.zeros(batch, dtype=np.int64)
        self.phase = 0  # slack-buffer phase of the group
        # phase each slot's window sits at (paused slots fall behind)
        self.slot_phase = np.zeros(batch, dtype=np.int64)
        self._pending_q: collections.deque[_Pending] = collections.deque()
        self._lock = threading.Lock()
        self._pending_resets: list[int] = []
        self._pending_drops: list[tuple[int, int]] = []
        # migration requests from the event loop, fulfilled at the top of
        # the next tick: (stream id, Future[snapshot]) and (snapshot,
        # stream id, trust_model, Future[slot])
        self._pending_exports: list[tuple] = []
        self._pending_imports: list[tuple] = []
        self.consumed_samples: dict[int, int] = {}
        self.total_ticks = 0
        self.total_steps = 0        # dispatches
        self.total_chunk_steps = 0  # chunk ticks (k per dispatch)
        self.total_audio_seconds = 0.0
        self.spans = Totals()  # the tick's phases (utils/trace.py)
        self.total_chunks = 0
        self.emit_latencies: collections.deque[float] = collections.deque(
            maxlen=4096)

    def prewarm(self) -> None:
        """Run each tick variant of the group's flow once on garbage state
        (builds the kernels, warms cuBLAS/cuDNN and the allocator), and each
        slot operation it can call between ticks twice (every realign delta,
        the compactions, the prime and the reset: on a graphed model each
        key warmed up, then captured), then reset every slot."""
        b, cfg, model = self.batch, self.cfg, self.model
        k_cap = max_safe_tick_chunks(cfg.n_phases, self.max_tick_chunks)
        half = np.zeros(b, dtype=bool)
        half[:max(1, b // 2)] = True
        every = np.ones(b, dtype=bool)
        for _ in range(2):
            self.state = model.prime_frontend(
                self.state, half, np.zeros((b, PP_TAIL_LEN), np.float32),
                np.zeros(b, np.float32), cfg=cfg)
        nv = np.full(b, cfg.valid_out_len, np.int16)
        zeros = np.zeros(b, np.int16)
        if self.phase_timers:
            for active in (None, half):
                self.state, _, _, _ = model.fused_tick_profiled(
                    cfg, self.state,
                    model.put_batch(np.zeros((b, cfg.shift_samples),
                                             np.int16)),
                    model.put_batch(nv.astype(np.int32)),
                    None if active is None else model.put_batch(active),
                    model.put_batch(zeros.astype(np.int32)), phase=0)
        else:
            for k, active in ((1, None), (1, half), (k_cap, None)):
                packed = model.pack_tick_inputs(
                    np.zeros((b, k * cfg.shift_samples), np.int16), nv,
                    zeros, active)
                self.state, _ = model.fused_tick_packed(
                    cfg, self.state, model.put_batch(packed), active is None,
                    phase=0, k=k, fast_gated=self.use_realign)
        for _ in range(2):
            if self.use_realign:
                for delta in range(1 - cfg.n_phases, cfg.n_phases):
                    if delta:
                        self.state = model.realign_state(cfg, self.state,
                                                         delta, half)
                self.state = model.compact_state(cfg, self.state, mask=half)
            else:
                for phase in range(1, cfg.n_phases):
                    self.state = model.compact_state(cfg, self.state,
                                                     phase=phase)
            self.state = model.compact_state(cfg, self.state)
            self.state = model.reset_state(self.state, every, cfg=cfg)
        model.synchronize()
        self.phase = 0
        self.slot_phase[:] = 0
        self.frame_offsets[:] = 0

    def has_free_slot(self) -> bool:
        return self.n_active_streams < self.batch

    def claim(self, stream_id: int, prompt_index: int) -> int | None:
        """Assign a slot (host bookkeeping only); the device reset is queued
        for the top of the next tick."""
        with self._lock:
            for i, s in enumerate(self.slots):
                if s is None:
                    self.slots[i] = _Slot(stream_id, prompt_index)
                    self._pending_resets.append(i)
                    self.n_active_streams += 1
                    return i
        return None

    def release(self, idx: int) -> None:
        with self._lock:
            if self.slots[idx] is not None:
                self.slots[idx] = None
                self.n_active_streams -= 1

    def drop(self, idx: int, stream_id: int) -> None:
        """Queue a disconnect release (applied at the top of the next tick)."""
        with self._lock:
            self._pending_drops.append((idx, stream_id))

    def _apply_pending_drops(self) -> None:
        with self._lock:
            drops, self._pending_drops = self._pending_drops, []
            for idx, sid in drops:
                s = self.slots[idx]
                if s is not None and s.stream_id == sid:
                    self.slots[idx] = None
                    self.n_active_streams -= 1

    def find(self, stream_id: int) -> int | None:
        for i, s in enumerate(self.slots):
            if s is not None and s.stream_id == stream_id:
                return i
        return None

    # --- live-stream migration ---------------------------------------------
    def queue_export(self, stream_id: int) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            self._pending_exports.append((stream_id, fut))
        return fut

    def queue_import(self, snapshot: dict, stream_id: int,
                     trust_model: bool = False) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            self._pending_imports.append((snapshot, stream_id, trust_model,
                                          fut))
        return fut

    def _apply_pending_migrations(self) -> list[Event]:
        """Fulfil queued exports and imports (tick thread). An export first
        drains every in-flight readback, so the slot's tokens are complete
        and no queued step still refers to it; the drained events are
        returned to the tick."""
        with self._lock:
            if not (self._pending_exports or self._pending_imports):
                return []
            exports, self._pending_exports = self._pending_exports, []
            imports, self._pending_imports = self._pending_imports, []
        if self.source is not None:
            # the native ingest stages PCM in C++ connection rings with no
            # injection API: a migrated tail would have nowhere to go
            # (clients of a native server migrate by reconnect and replay)
            err = NotImplementedError(
                "live-stream migration is not supported on native-ingest "
                "engines")
            for _sid, fut in exports:
                fut.set_exception(err)
            for _snap, _sid, _trust, fut in imports:
                fut.set_exception(err)
            return []
        events: list[Event] = []
        if exports:
            events.extend(self._drain_pending(force_all=True))
            self._drain_queues()
            found = []
            for sid, fut in exports:
                idx = self.find(sid)
                if idx is None or idx in (i for i, _ in found):
                    fut.set_exception(KeyError(sid))  # a repeat: it has left
                elif self.slots[idx].finalize_sent:
                    fut.set_exception(RuntimeError(
                        f"stream {sid} is finalizing; too late to export"))
                else:
                    found.append((idx, fut))
            if found:  # one gather and one host copy per leaf for all
                states = extract_slots(self.state, [i for i, _ in found])
                for (idx, fut), snap_state in zip(found, states):
                    fut.set_result(self._export_slot(idx, snap_state))
        for snap, sid, trust, fut in imports:
            try:
                fut.set_result(self._import_slot(snap, sid, trust))
            except Exception as e:  # noqa: BLE001
                fut.set_exception(e)
        return events

    def _export_slot(self, idx: int, snap_state) -> dict:
        """Snapshot one live slot (its device state, extracted, its host
        bookkeeping and staged audio) and release it. The caller must have
        stopped pushing audio for the stream: a push racing the export may
        be lost."""
        slot = self.slots[idx]
        stage = (np.concatenate(slot.stage).astype(np.int16)
                 if slot.stage else np.zeros(0, np.int16))
        snap = {
            "version": 1,
            "right_context": int(self.cfg.att_right_context),
            "n_phases": int(self.cfg.n_phases),
            "kv_int8": bool(is_quant(snap_state.k_cache)),
            "model_fp": self.model.weights_fingerprint,
            "phase": int(self.slot_phase[idx]),
            "frame_offset": int(self.frame_offsets[idx]),
            "state": snap_state,
            "stage": stage,
            "tokens": list(slot.tokens),
            "token_frames": list(slot.token_frames),
            "transcript": slot.transcript,
            "prompt_index": int(slot.prompt_index),
            "total_pushed": int(slot.total_pushed),
            "steps": int(slot.steps),
            "primed": bool(slot.primed),
            "ending": bool(slot.ending),
        }
        self.release(idx)
        return snap

    def _import_slot(self, snap: dict, stream_id: int,
                     trust_model: bool = False) -> int:
        """Install a snapshot into a free slot; returns the slot index.

        The snapshot's K/V window is realigned from the exporter's phase to
        this group's on the host, a numpy roll of the S axis of every K/V
        leaf (a QuantKV's scales too; the same roll as realign_cache), so
        engines at different points of their compaction cycle interoperate.
        A group with no live slot takes the snapshot's phase instead (its
        phase is free then), so a hot swap's imports roll nothing."""
        if snap.get("version") != 1:
            raise ValueError(f"unknown snapshot version {snap.get('version')}")
        if int(snap["right_context"]) != int(self.cfg.att_right_context):
            raise ValueError("snapshot latency mode differs from this group")
        if int(snap["n_phases"]) != int(self.cfg.n_phases):
            raise ValueError("snapshot n_phases differs from this group")
        if bool(snap["kv_int8"]) != bool(self.model.kv_int8):
            raise ValueError("snapshot kv-int8 mode differs from this group")
        fp = snap.get("model_fp")
        if (not trust_model and fp is not None
                and fp != self.model.weights_fingerprint):
            raise ValueError(
                "snapshot model fingerprint differs from this engine's "
                "weights (same shapes, different checkpoint/vocab -- "
                "installing it would silently produce garbage transcripts)")
        with self._lock:
            idx = next((i for i, s in enumerate(self.slots) if s is None),
                       None)
            if idx is None:
                raise RuntimeError("no free stream slots")
            if self.n_active_streams == 0:
                self.phase = int(snap["phase"])
                self.slot_phase[:] = self.phase
            slot = _Slot(stream_id, int(snap["prompt_index"]))
            self.slots[idx] = slot
            self.n_active_streams += 1
        snap_state = snap["state"]
        delta = self.phase - int(snap["phase"])
        if delta:
            shift = delta * self.cfg.chunk_len(self.hp)

            def roll(buf):
                if is_quant(buf):
                    return QuantKV(np.roll(buf.q, shift, axis=3),
                                   np.roll(buf.s, shift, axis=3))
                return np.roll(np.asarray(buf), shift, axis=3)

            snap_state = dataclasses.replace(
                snap_state, k_cache=roll(snap_state.k_cache),
                v_cache=roll(snap_state.v_cache))
        try:
            self.state = install_slot(self.state, idx, snap_state)
        except Exception:
            # e.g. a foreign shape: nothing was written; free the slot
            self.release(idx)
            raise
        self.slot_phase[idx] = self.phase
        self.frame_offsets[idx] = int(snap["frame_offset"])
        slot.tokens = list(snap["tokens"])
        slot.token_frames = list(snap["token_frames"])
        slot.transcript = snap["transcript"]
        slot.total_pushed = int(snap["total_pushed"])
        slot.steps = int(snap["steps"])
        slot.primed = bool(snap["primed"])
        slot.ending = bool(snap["ending"])
        st = np.asarray(snap["stage"], np.int16)
        if st.size:
            slot.stage.append(st)
            slot.staged = int(st.size)
        return idx

    # -----------------------------------------------------------------------
    def push_audio(self, idx: int, audio: np.ndarray) -> None:
        slot = self.slots[idx]
        if slot is not None:
            slot.audio_queue.append(audio)

    def end_stream(self, idx: int) -> None:
        slot = self.slots[idx]
        if slot is not None:
            slot.ending = True

    def _apply_pending_resets(self) -> None:
        with self._lock:
            resets, self._pending_resets = self._pending_resets, []
        if not resets:
            return
        mask = np.zeros(self.batch, dtype=bool)
        mask[resets] = True
        self.state = self.model.reset_state(self.state, mask,
                                            cfg=self.cfg)
        self.frame_offsets[resets] = 0
        self.slot_phase[resets] = self.phase  # no history: trivially aligned

    def _drain_queues(self) -> None:
        """Move pushed audio into the tick-owned stages (the consumption
        point for the admission budget)."""
        consumed: dict[int, int] = {}
        for s in self.slots:
            if s is None or not s.audio_queue:
                continue
            q, s.audio_queue = s.audio_queue, []  # atomic swap
            for a in q:
                a = np.asarray(a)
                if not np.issubdtype(a.dtype, np.integer):
                    a = np.clip(a * 32768.0, -32768, 32767)
                s.stage.append(a.astype(np.int16))
                s.staged += len(a)
                s.total_pushed += len(a)
                consumed[s.stream_id] = consumed.get(s.stream_id, 0) + len(a)
        if consumed:
            with self._lock:
                for sid, n in consumed.items():
                    self.consumed_samples[sid] = (
                        self.consumed_samples.get(sid, 0) + n)

    def _refresh_native(self) -> None:
        """Pull each slot's staging status from the native ingest layer (one
        call in place of _drain_queues: PCM stays in the C++ rings until
        the tick's block is filled)."""
        idxs = [i for i, s in enumerate(self.slots)
                if s is not None and not s.finalize_sent]
        if not idxs:
            return
        sids = np.array([self.slots[i].stream_id for i in idxs], np.uint32)
        staged, pushed = self.source.status(sids)
        for j, i in enumerate(idxs):
            if staged[j] >= 0:  # -1: dropped natively, its event is pending
                self.slots[i].staged = int(staged[j])
                self.slots[i].total_pushed = int(pushed[j])

    def _prime_new_slots(self) -> None:
        """Fold each new stream's first 96 samples into its frontend carry."""
        rows = [i for i, s in enumerate(self.slots)
                if s is not None and not s.primed
                and s.staged >= PRIME_SAMPLES]
        if not rows:
            return
        raw = np.zeros((len(rows), PRIME_SAMPLES), np.int16)
        if self.source is not None:
            sids = np.array([self.slots[i].stream_id for i in rows],
                            np.uint32)
            self.source.take_block(
                sids, np.full(len(rows), PRIME_SAMPLES, np.int32), raw)
            for i in rows:
                self.slots[i].staged -= PRIME_SAMPLES
        else:
            for j, i in enumerate(rows):
                raw[j] = self.slots[i].take(PRIME_SAMPLES)
        mask = np.zeros(self.batch, dtype=bool)
        tails = np.zeros((self.batch, PP_TAIL_LEN), np.float32)
        lasts = np.zeros(self.batch, np.float32)
        for j, i in enumerate(rows):
            tails[i], lasts[i] = prime_carry(raw[j])
            mask[i] = True
            self.slots[i].primed = True
        self.state = self.model.prime_frontend(self.state, mask, tails, lasts,
                                               cfg=self.cfg)

    def drain_consumed(self) -> dict[int, int]:
        with self._lock:
            out, self.consumed_samples = self.consumed_samples, {}
        return out

    @staticmethod
    def _frames_total(slot: _Slot) -> int:
        """Mel frames the stream's samples yield (centre pad 256, frame 512,
        hop 160)."""
        avail = 256 + slot.total_pushed
        if avail < 512:
            return 0
        return (avail - 512 + 160) // 160

    def _drain_pending(self, force_all: bool) -> list[Event]:
        """Collect dispatched steps FIFO, each followed by the `ended`
        events waiting on it. The oldest step is collected once a newer
        one has been dispatched, when more than readback_depth steps are
        in flight (at a depth >= 1 implied by the first), or when
        force_all (idle ticks, migrations). The queue holds steps only,
        so a tick that dispatches never waits on its own step:
        `engine.readback_wait` counts such a readback as `same_tick`,
        which this rule keeps at 0."""
        events: list[Event] = []
        while self._pending_q:
            in_flight = len(self._pending_q)
            if not (force_all or in_flight > 1
                    or in_flight > self.readback_depth):
                break
            head = self._pending_q.popleft()
            with self.spans.span("engine.readback_wait",
                                 same_tick=int(head.tick == self.total_ticks)):
                if head.ready is not None:
                    head.ready.synchronize()
                head.result = head.tokens_host.numpy()
                head.tokens_host = head.ready = None
            with self.spans.span("engine.scatter"):
                events.extend(self._process_pending(head))
            self.emit_latencies.append(time.perf_counter() - head.t_dispatch)
            events.extend(self._emit_ended(head.ends))
        return events

    def _emit_ended(self, ends: list[tuple[int, int]]) -> list[Event]:
        """The `ended` events of streams that ended with no row left to
        finalize, each releasing its slot (unless dropped or reused)."""
        events = []
        for i, sid in ends:
            events.append(Event(sid, "ended", ""))
            slot = self.slots[i]
            if slot is not None and slot.stream_id == sid:
                self.release(i)
        return events

    def _process_pending(self, pending: _Pending) -> list[Event]:
        """Scatter one step's tokens into the slots' tokens and transcripts,
        with each event's decode position and minimum confidence."""
        tok_np = pending.result
        events: list[Event] = []
        for i in np.nonzero(pending.active)[0]:
            slot = self.slots[i]
            if slot is None or slot.stream_id != pending.stream_ids[i]:
                continue  # slot dropped / reused since dispatch
            emitted = tok_np[i]  # [T, S]
            mask = emitted >= 0
            # the end of the step's VALID frame window: a finalize row
            # decodes only its n_valid leftover frames, and the buffer's
            # width would place its text past the end of the audio
            at = float(pending.frame_base[i] + pending.n_valid[i]) \
                * self.cfg.subsampling_factor * 160.0 / 16000.0
            conf, text = -1.0, ""
            if mask.any():
                ids = emitted[mask]  # frame-major order
                if self.model.confidence:
                    ids, confs = unpack_tokens(ids, self.hp.vocab_size)
                    conf = float(confs.min())
                ids = ids.tolist()
                slot.tokens.extend(ids)
                slot.token_frames.extend(
                    (pending.frame_base[i] + np.nonzero(mask)[0]).tolist())
                text = self.model.tokenizer.decode(ids)
                slot.transcript += text
            if i in pending.finalizing:
                events.append(Event(slot.stream_id, "ended", text, at, conf))
                self.release(i)
            elif text:
                events.append(Event(slot.stream_id, "text", text, at, conf))
        return events

    def _start_readback(self, tokens: torch.Tensor, entry: _Pending) -> None:
        """Start the device->host token copy now; it is collected later."""
        if tokens.is_cuda:
            entry.tokens_host = tokens.to("cpu", non_blocking=True)
            entry.ready = torch.cuda.Event()
            entry.ready.record()
        else:
            entry.tokens_host = tokens

    def tick(self) -> tuple[list[Event], bool]:
        """One batched round: dispatch the next fused step, then scatter
        older readbacks. Returns (events, more_work_pending). The round is
        one `engine.tick` span, its phases spans under it (see the module
        docstring); the root counts the rows that carry audio
        (`rows_active`) and the text and ended events returned."""
        self.total_ticks += 1
        with self.spans.span("engine.tick") as root:
            events, more = self._tick(root)
            n_text = sum(e.kind == "text" for e in events)
            root.set(text_events=n_text, ended_events=len(events) - n_text)
        return events, more

    def _tick(self, root) -> tuple[list[Event], bool]:
        cfg = self.cfg
        shift = cfg.shift_samples
        b = self.batch
        sp = self.spans
        events: list[Event] = []

        with sp.span("engine.admin"):
            self._apply_pending_drops()
            self._apply_pending_resets()
            events.extend(self._apply_pending_migrations())
        with sp.span("engine.ingest"):
            if self.source is None:
                self._drain_queues()
            else:
                self._refresh_native()
        with sp.span("engine.prime"):
            self._prime_new_slots()

        with sp.span("engine.scan"):
            n_valid = np.zeros(b, dtype=np.int32)
            active = np.zeros(b, dtype=bool)
            prompt_idx = np.zeros(b, dtype=np.int32)
            ready = np.zeros(b, dtype=bool)
            finalizing: set[int] = set()
            fin_nv: dict[int, int] = {}
            ended_now: list[tuple[int, int]] = []

            for i, slot in enumerate(self.slots):
                if slot is None or slot.finalize_sent:
                    continue
                prompt_idx[i] = max(slot.prompt_index, 0)
                if slot.primed and slot.staged >= shift:
                    ready[i] = True
                elif slot.ending and not slot.audio_queue:
                    # leftover frames beyond the steady chunks already
                    # dispatched
                    left = (self._frames_total(slot)
                            - cfg.shift_mel_frames * slot.steps)
                    nv = left // cfg.subsampling_factor if left > 0 else 0
                    if nv > 0:
                        fin_nv[i] = nv
                    else:
                        slot.finalize_sent = True
                        ended_now.append((i, slot.stream_id))

            # backlog micro-batching: every slot occupied, steady, and at
            # least k_cap chunks staged; starts only at phases divisible
            # by k_cap
            k = 1
            k_cap = max_safe_tick_chunks(cfg.n_phases, self.max_tick_chunks)
            if (k_cap > 1 and not self.phase_timers and not fin_nv
                    and not ended_now and bool(ready.all())
                    and self.phase % k_cap == 0
                    and min(s.staged // shift for s in self.slots) >= k_cap):
                k = k_cap

        with sp.span("engine.take"):
            block = np.zeros((b, k * shift), dtype=np.int16)
            if self.source is not None and (bool(ready.any()) or fin_nv):
                # ONE native call fills every active row from the C++
                # staging rings (a finalize row's partial block zero-padded)
                take_sids = np.zeros(b, np.uint32)
                take_n = np.zeros(b, np.int32)
                for i in np.nonzero(ready)[0]:
                    take_sids[i] = self.slots[i].stream_id
                    take_n[i] = k * shift
                for i in fin_nv:
                    take_sids[i] = self.slots[i].stream_id
                    take_n[i] = shift
                self.source.take_block(take_sids, take_n, block)
            for i in np.nonzero(ready)[0]:
                slot = self.slots[i]
                if self.source is None:
                    block[i] = slot.take(k * shift)
                else:
                    slot.staged = max(0, slot.staged - k * shift)
                n_valid[i] = cfg.valid_out_len
                active[i] = True
                slot.steps += k
            for i, nv in fin_nv.items():
                slot = self.slots[i]
                if self.source is None:
                    block[i, :shift] = slot.take(shift)  # zero-padded partial
                else:
                    slot.staged = max(0, slot.staged - shift)
                n_valid[i] = nv
                active[i] = True
                finalizing.add(i)
                slot.finalize_sent = True

        n_act = int(np.count_nonzero(active))
        root.set(rows_active=n_act)
        if n_act:
            with sp.span("engine.step"):
                events.extend(self._step(block, n_valid, prompt_idx, active,
                                         finalizing, ended_now, k, n_act))
        else:
            events.extend(self._drain_pending(force_all=True))
            events.extend(self._emit_ended(ended_now))

        with sp.span("engine.more"):
            with self._lock:
                migrations = bool(self._pending_exports
                                  or self._pending_imports)
            more = bool(self._pending_q) or migrations or any(
                s is not None and not s.finalize_sent
                and ((s.primed and s.staged >= shift) or s.audio_queue
                     or s.ending)
                for s in self.slots)
        return events, more

    def _step(self, block, n_valid, prompt_idx, active, finalizing,
              ended_now, k: int, n_act: int) -> list[Event]:
        """The dispatching part of a tick (the `engine.step` span): the
        slot operations, the fused step's inputs, its dispatch and the
        readbacks that are due; returns their events."""
        cfg = self.cfg
        shift = cfg.shift_samples
        b = self.batch
        sp = self.spans
        self.total_steps += 1
        self.total_chunk_steps += k
        self.total_chunks += n_act * k
        self.total_audio_seconds += n_act * k * shift / cfg.sample_rate
        all_active = n_act == b
        frame_base = self.frame_offsets.copy()
        stream_ids = np.full(b, -1, dtype=np.int64)
        for i in np.nonzero(active)[0]:
            stream_ids[i] = self.slots[i].stream_id
        with sp.span("engine.slot_ops") as ops:
            if self.use_realign:
                # realign-on-resume: slots whose window fell behind the
                # group phase get one masked roll per distinct delta
                deltas: dict[int, list[int]] = {}
                for i in np.nonzero(active)[0]:
                    d = self.phase - int(self.slot_phase[i])
                    if d:
                        deltas.setdefault(d, []).append(i)
                for d, idxs in deltas.items():
                    m = np.zeros(b, dtype=bool)
                    m[idxs] = True
                    self.state = self.model.realign_state(
                        cfg, self.state, d, m)
                    self.slot_phase[idxs] = self.phase
                ops.set(calls=len(deltas))
            elif not all_active and self.phase != 0:
                # legacy flow: gated ticks run at phase 0; move the live
                # windows (all at the group's phase) back there first
                self.state = self.model.compact_state(cfg, self.state,
                                                      phase=self.phase)
                self.phase = 0
                # every window moved (an export reads its phase here;
                # the JAX engine leaves slot_phase stale at this point)
                self.slot_phase[:] = 0
                ops.set(calls=1)

        if self.phase_timers:
            with sp.span("engine.upload"):
                put = self.model.put_batch
                block_dev, nv_dev, prompt_dev = (
                    put(block), put(n_valid), put(prompt_idx))
                active_dev = None if all_active else put(active)
            with sp.span("engine.dispatch"):
                self.state, tokens, _, _ = \
                    self.model.fused_tick_profiled(
                        cfg, self.state, block_dev, nv_dev, active_dev,
                        prompt_dev, phase=self.phase, spans=sp)
                entry = self._dispatched(tokens, active, n_valid,
                                         finalizing, frame_base,
                                         stream_ids)
        else:
            with sp.span("engine.pack"):
                packed = self.model.pack_tick_inputs(
                    block, n_valid, prompt_idx,
                    None if all_active else active)
            with sp.span("engine.upload"):
                packed_dev = self.model.put_batch(packed)
            with sp.span("engine.dispatch"):
                self.state, tokens = self.model.fused_tick_packed(
                    cfg, self.state, packed_dev, all_active,
                    phase=self.phase, k=k, fast_gated=self.use_realign)
                entry = self._dispatched(tokens, active, n_valid,
                                         finalizing, frame_base,
                                         stream_ids)

        if k > 1:  # wrap compaction already ran inside the k-chunk tick
            self.phase = (self.phase + k) % cfg.n_phases
            self.slot_phase[:] = self.phase
        elif all_active or self.use_realign:
            self.slot_phase[active] = self.phase + 1
            self.phase += 1
            if self.phase >= cfg.n_phases:
                aligned = self.slot_phase == cfg.n_phases
                # paused slots' windows sit mid-buffer: the wrap must not
                # clobber them (masked compaction)
                with sp.span("engine.slot_ops", calls=1):
                    self.state = self.model.compact_state(
                        cfg, self.state,
                        mask=None if bool(aligned.all()) else aligned)
                self.slot_phase[aligned] = 0
                self.phase = 0
        # (a legacy gated tick is phase-stationary: no phase moves)
        self.frame_offsets[active] += k * n_valid[active]
        entry.ends = ended_now
        self._pending_q.append(entry)
        return self._drain_pending(force_all=False)

    def _dispatched(self, tokens, active, n_valid, finalizing, frame_base,
                    stream_ids) -> _Pending:
        """The readback entry of the step just dispatched, its tokens'
        host copy started."""
        entry = _Pending(
            active=active, n_valid=n_valid, finalizing=finalizing,
            frame_base=frame_base, stream_ids=stream_ids,
            tick=self.total_ticks, t_dispatch=time.perf_counter())
        self._start_readback(tokens, entry)
        return entry


class BatchedEngine:
    """Multi-latency-mode engine; owns one EngineGroup per right_context.
    gated_realign, phase_timers, readback_depth, max_tick_chunks and the
    native ingest `source` go to each group (EngineGroup)."""

    def __init__(self, model, batch_per_group: int = 32,
                 gated_realign: bool = True, phase_timers: bool = False,
                 readback_depth: int = READBACK_DEPTH,
                 max_tick_chunks: int = MAX_TICK_CHUNKS, source=None):
        self.model = model
        self.batch = batch_per_group
        self.gated_realign = gated_realign
        self.phase_timers = phase_timers
        self.readback_depth = max(1, int(readback_depth))
        self.max_tick_chunks = max(1, int(max_tick_chunks))
        self.source = source
        self.groups: dict[int, EngineGroup] = {}
        self._groups_lock = threading.Lock()
        self._ids = itertools.count(1)
        self._route: dict[int, tuple[int, int]] = {}  # stream -> (rc, slot)

    def _group(self, rc: int) -> EngineGroup:
        group = self.groups.get(rc)
        if group is None:
            with self._groups_lock:
                group = self.groups.get(rc)
                if group is None:
                    group = EngineGroup(
                        self.model, self.model.cache_config(rc), self.batch,
                        gated_realign=self.gated_realign,
                        phase_timers=self.phase_timers,
                        readback_depth=self.readback_depth,
                        max_tick_chunks=self.max_tick_chunks,
                        source=self.source)
                    self.groups[rc] = group
        return group

    def prewarm(self, right_contexts=(0,)) -> None:
        for rc in right_contexts:
            self._group(int(rc)).prewarm()

    def start_stream(self, right_context: int = 0, lang: str | None = None) -> int:
        group = self._group(int(right_context))
        prompt_index = self.model.default_prompt_index
        if lang:
            idx = self.model.resolve_language(lang)
            if idx is not None:
                prompt_index = idx
        stream_id = next(self._ids)
        slot = group.claim(stream_id, prompt_index)
        if slot is None:
            raise RuntimeError("no free stream slots")
        self._route[stream_id] = (int(right_context), slot)
        return stream_id

    def set_language(self, stream_id: int, lang: str) -> int | None:
        """The prompt index, None for an unknown language; KeyError for an
        unknown or just-ended stream."""
        idx = self.model.resolve_language(lang)
        if idx is None:
            return None
        rc, slot = self._route[stream_id]
        s = self.groups[rc].slots[slot]
        if s is None or s.stream_id != stream_id:
            raise KeyError(stream_id)
        s.prompt_index = idx
        return idx

    def push_audio(self, stream_id: int, audio_i16: np.ndarray) -> None:
        route = self._route.get(stream_id)
        if route is not None:
            rc, slot = route
            self.groups[rc].push_audio(slot, audio_i16)

    def end_stream(self, stream_id: int) -> None:
        route = self._route.get(stream_id)
        if route is not None:
            rc, slot = route
            self.groups[rc].end_stream(slot)

    def drop_stream(self, stream_id: int) -> None:
        """Disconnect without finalize; the release is queued to the tick."""
        route = self._route.pop(stream_id, None)
        if route:
            rc, slot = route
            self.groups[rc].drop(slot, stream_id)

    def drain_consumed(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for g in list(self.groups.values()):
            for sid, n in g.drain_consumed().items():
                out[sid] = out.get(sid, 0) + n
        return out

    # --- live-stream migration ---------------------------------------------
    def request_export(self, stream_id: int) -> concurrent.futures.Future:
        """Queue a live-stream export. The Future resolves on the tick
        thread, at the top of its next tick, to a snapshot dict: the slot's
        device state (numpy leaves), its staged audio and its transcript
        bookkeeping; the stream then leaves this engine. The caller must
        stop pushing audio for the stream first. snapshot_to_bytes /
        snapshot_from_bytes carry a snapshot across processes and between
        this package and the JAX one. KeyError for an unknown stream."""
        route = self._route.get(stream_id)
        if route is None:
            raise KeyError(stream_id)
        fut = self.groups[route[0]].queue_export(stream_id)

        def done(f: concurrent.futures.Future) -> None:
            if not f.cancelled() and f.exception() is None:
                self._route.pop(stream_id, None)

        fut.add_done_callback(done)
        return fut

    def request_import(self, snapshot: dict, stream_id: int | None = None,
                       trust_model: bool = False) -> concurrent.futures.Future:
        """Queue a snapshot for adoption. The Future resolves to the stream
        id once the tick thread has installed the slot (its K/V window
        realigned to this engine's slack-buffer phase).

        stream_id: keep this id instead of a fresh one (a hot swap: the wire
        protocol pins ids); an id live on this engine raises ValueError, and
        the id counter skips past it. trust_model: skip the snapshot's
        weights-fingerprint check, for deliberate operator actions only (a
        hot swap to new weights installs the old model's caches by design)."""
        rc = int(snapshot["right_context"])
        group = self._group(rc)
        if stream_id is None:
            stream_id = next(self._ids)
        else:
            if stream_id in self._route:
                raise ValueError(
                    f"stream id {stream_id} is already live on this engine")
            nxt = next(self._ids)
            if stream_id >= nxt:
                self._ids = itertools.count(stream_id + 1)
        slot_fut = group.queue_import(snapshot, stream_id, trust_model)
        out: concurrent.futures.Future = concurrent.futures.Future()

        def done(f: concurrent.futures.Future) -> None:
            if f.cancelled():
                out.cancel()
            elif f.exception() is not None:
                out.set_exception(f.exception())
            else:
                self._route[stream_id] = (rc, f.result())
                out.set_result(stream_id)

        slot_fut.add_done_callback(done)
        return out

    def transcript(self, stream_id: int) -> str:
        rc, slot = self._route[stream_id]
        s = self.groups[rc].slots[slot]
        return s.transcript if s else ""

    def stats(self) -> dict:
        """Engine counters per latency group, from each group's span table
        (utils/trace.py; host clock, seconds): the tick's and each phase's
        seconds (`transfer_seconds` is the readback wait; `step_seconds`,
        and `rtf` over the audio dispatched, the dispatching ticks' path
        from the slot operations to the readbacks collected after the
        dispatch: the `engine.step` span), the rows that carried audio
        summed over ticks (`rows_active`) beside the rows dispatched
        (slots x dispatches), the slot operations issued, the text and
        ended events returned and the readbacks that collected the step
        their own tick dispatched (`readbacks_same_tick`); each group's
        compiled ticks and slot operations (graphs: keys, captures,
        recaptures, replays, pool bytes, capture seconds; graphs.py); with
        phase_timers also each group's encoder_seconds /
        decoder_seconds."""
        out = {"streams": len(self._route),
               "device": self.model.backend_name, "groups": {}}
        for rc, g in list(self.groups.items()):
            count = g.spans.count
            # a phase's seconds, 0 if never run (the table copied at once:
            # the tick thread may add a phase while another thread reads)
            sec = collections.Counter({
                n.removeprefix("engine."): x
                for n, x in dict(g.spans.seconds).items()})
            rtf = sec["step"] / g.total_audio_seconds \
                if g.total_audio_seconds else 0.0
            grp = out["groups"][rc] = {
                "active_slots": g.n_active_streams,
                "ticks": g.total_ticks,
                "steps": g.total_steps,
                "chunk_steps": g.total_chunk_steps,
                "chunks": g.total_chunks,
                "audio_seconds": round(g.total_audio_seconds, 2),
                "step_seconds": round(sec["step"], 3),
                "transfer_seconds": round(sec["readback_wait"], 3),
                "upload_seconds": round(sec["upload"], 3),
                "tick_seconds": round(sec["tick"], 3),
                "pack_seconds": round(sec["pack"], 3),
                "scatter_seconds": round(sec["scatter"], 3),
                "dispatch_seconds": round(sec["dispatch"], 3),
                "rtf": round(rtf, 5),
            }
            for p in ("admin", "ingest", "prime", "scan", "take",
                      "slot_ops", "more"):
                grp[f"{p}_seconds"] = round(sec[p], 3)
            for key in ("rows_active", "text_events", "ended_events"):
                grp[key] = count("engine.tick", key)
            grp["rows_dispatched"] = g.batch * g.total_steps
            grp["readbacks_same_tick"] = count("engine.readback_wait",
                                               "same_tick")
            grp["slot_ops"] = count("engine.slot_ops", "calls")
            lat = np.asarray(list(g.emit_latencies)) * 1e3
            if lat.size:
                p50, p90, p99 = np.percentile(lat, (50, 90, 99))
                grp["emit_latency_ms"] = {
                    "p50": round(float(p50), 1), "p90": round(float(p90), 1),
                    "p99": round(float(p99), 1), "n": int(lat.size)}
            gs = self.model.graphs.stats(lambda key, g=g: _group_key(g, key))
            grp["graphs"] = {
                k: gs[k] for k in ("keys", "captures", "recaptures",
                                   "replays", "pool_bytes")}
            grp["graphs"]["capture_seconds"] = round(gs["capture_seconds"], 3)
            if g.phase_timers:
                grp["encoder_seconds"] = round(sec["encoder"], 3)
                grp["decoder_seconds"] = round(sec["decoder"], 3)
        return out

    def tick(self) -> tuple[list[Event], bool]:
        events: list[Event] = []
        more = False
        for group in list(self.groups.values()):
            ev, m = group.tick()
            events.extend(ev)
            more = more or m
        for e in events:
            if e.kind == "ended":
                self._route.pop(e.stream_id, None)
        return events, more


def snapshot_to_bytes(snap: dict) -> bytes:
    """Serialize a live-stream snapshot (BatchedEngine.request_export) in
    the JAX package's byte format (nemotron_tpu/streaming/engine.py:
    snapshot_to_bytes), so either package loads the other's: an np.savez
    of `meta` (the snapshot's other keys as JSON, plus leaf_dtypes),
    `stage`, `tokens`, `token_frames`, `n_leaves` and `leaf_{i}` in the
    JAX pytree order (streaming/state.state_leaves), bf16 leaves as uint16
    bit patterns named "bfloat16" in meta["leaf_dtypes"]."""
    import io
    import json

    leaves = [np.asarray(x) for x in state_leaves(snap["state"])]
    meta = {k: v for k, v in snap.items()
            if k not in ("state", "stage", "tokens", "token_frames")}
    # a uint16 leaf is a bf16 bit pattern (streaming/state.to_numpy)
    meta["leaf_dtypes"] = ["bfloat16" if x.dtype == np.uint16 else
                           str(x.dtype) for x in leaves]
    buf = io.BytesIO()
    np.savez(
        buf,
        meta=np.frombuffer(json.dumps(meta).encode("utf-8"), np.uint8),
        stage=np.asarray(snap["stage"], np.int16),
        tokens=np.asarray(snap["tokens"], np.int64),
        token_frames=np.asarray(snap["token_frames"], np.int64),
        n_leaves=len(leaves),
        **{f"leaf_{i}": x for i, x in enumerate(leaves)},
    )
    return buf.getvalue()


def snapshot_from_bytes(data: bytes, model) -> dict:
    """Rebuild a snapshot dict from snapshot_to_bytes' bytes (either
    package's). Its kv-int8 mode must match `model.kv_int8` (the number of
    K/V leaves depends on it); bf16 leaves stay uint16 bit patterns, as
    extract_slot gives them."""
    import io
    import json

    z = np.load(io.BytesIO(data))
    meta = json.loads(bytes(z["meta"]).decode("utf-8"))
    if bool(meta["kv_int8"]) != bool(model.kv_int8):
        raise ValueError(
            "snapshot kv-int8 mode differs from this model's (build the "
            "model with kv_int8 matching the exporter)")
    n = int(z["n_leaves"])
    dtypes = meta.pop("leaf_dtypes", None) or [None] * n
    leaves = []
    for i in range(n):
        a = z[f"leaf_{i}"]
        if dtypes[i] == "bfloat16":
            a = a.view(np.uint16)
        elif dtypes[i] is not None and dtypes[i] != str(a.dtype):
            a = a.view(np.dtype(dtypes[i]))
        leaves.append(a)
    snap = dict(meta)
    snap["state"] = state_from_leaves(leaves, bool(meta["kv_int8"]))
    snap["stage"] = z["stage"]
    snap["tokens"] = [int(t) for t in z["tokens"]]
    snap["token_frames"] = [int(t) for t in z["token_frames"]]
    return snap
