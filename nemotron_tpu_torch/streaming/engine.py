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
claim / push_audio / end_stream / drop. claim only queues a slot reset,
push_audio appends to a queue that tick drains with an atomic list swap,
and drops are applied at the top of the next tick.

Ported: start, push, end and drop; the all-active tick; the masked fast
tick with realign-on-resume; wrap compaction (masked when slots are paused
mid-cycle); finalize with reduced n_valid; the k-chunk backlog tick; the
readback FIFO; transcript and stats. Not ported yet: live-stream migration
and snapshots, native ingest, phase timers, the legacy phase-stationary
gated tick, and per-token confidences in events (a model built with
confidence=True is refused).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time

import numpy as np
import torch

from ..streaming.state import PP_TAIL_LEN, reset_slots

# Token readbacks lag dispatch by up to this many ticks.
READBACK_DEPTH = 2

# Backlog micro-batching: when every slot is occupied, steady and has this
# many chunks staged, one tick advances every stream by k chunks. Clamped to
# the largest divisor of n_phases (the k-chunk tick's phase contract).
MAX_TICK_CHUNKS = 8

# Samples folded into the frontend carry at stream start: the carry becomes
# [256 centre-pad zeros || preemph(first 96 samples)], after which every
# shift_samples block yields exactly shift_mel_frames frames.
PRIME_SAMPLES = PP_TAIL_LEN - 256  # 96
PREEMPH = 0.97


def max_safe_tick_chunks(n_phases: int) -> int:
    k = min(MAX_TICK_CHUNKS, n_phases)
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
    """One entry of the FIFO readback queue: a dispatched step's tokens
    ("tokens"), or an end-of-stream sentinel ("ended") that must not
    overtake the stream's last in-flight tokens."""

    kind: str
    tokens_host: object = None  # CPU tensor being filled by an async copy
    ready: object = None        # torch.cuda.Event recorded after the copy
    result: object = None
    active: object = None
    finalizing: object = None
    stream_ids: object = None
    slot_idx: int = -1
    stream_id: int = -1
    t_dispatch: float = 0.0


@dataclasses.dataclass
class Event:
    stream_id: int
    kind: str  # "text" | "ended"
    text: str


class _Slot:
    __slots__ = (
        "stream_id", "transcript", "prompt_index", "ending", "finalize_sent",
        "audio_queue", "stage", "staged", "primed", "total_pushed", "steps",
    )

    def __init__(self, stream_id: int, prompt_index: int):
        self.stream_id = stream_id
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
    """All streams of one latency mode, stepped as one batch."""

    def __init__(self, model, cfg, batch: int):
        self.model = model
        self.cfg = cfg
        self.batch = batch
        self.hp = model.hp
        self.state = model.init_stream_state(batch, cfg)
        self.slots: list[_Slot | None] = [None] * batch
        self.n_active_streams = 0
        self.phase = 0  # slack-buffer phase of the group
        # phase each slot's window sits at (paused slots fall behind)
        self.slot_phase = np.zeros(batch, dtype=np.int64)
        self._pending_q: collections.deque[_Pending] = collections.deque()
        self._lock = threading.Lock()
        self._pending_resets: list[int] = []
        self._pending_drops: list[tuple[int, int]] = []
        self.consumed_samples: dict[int, int] = {}
        self.total_ticks = 0
        self.total_steps = 0        # dispatches
        self.total_chunk_steps = 0  # chunk ticks (k per dispatch)
        self.total_step_seconds = 0.0
        self.total_transfer_seconds = 0.0  # blocked on token readbacks
        self.total_upload_seconds = 0.0
        self.total_tick_seconds = 0.0
        self.total_dispatch_seconds = 0.0
        self.total_pack_seconds = 0.0
        self.total_scatter_seconds = 0.0
        self.total_audio_seconds = 0.0
        self.total_chunks = 0
        self.emit_latencies: collections.deque[float] = collections.deque(
            maxlen=4096)

    def prewarm(self) -> None:
        """Run each tick variant once on garbage state (builds the kernels,
        warms cuBLAS/cuDNN and the allocator), then reset every slot."""
        b, cfg = self.batch, self.cfg
        k_cap = max_safe_tick_chunks(cfg.n_phases)
        half = np.zeros(b, dtype=bool)
        half[:max(1, b // 2)] = True
        self.state = self.model.prime_frontend(
            self.state, half, np.zeros((b, PP_TAIL_LEN), np.float32),
            np.zeros(b, np.float32))
        nv = np.full(b, cfg.valid_out_len, np.int16)
        zeros = np.zeros(b, np.int16)
        for k, active in ((1, None), (1, half), (k_cap, None)):
            packed = self.model.pack_tick_inputs(
                np.zeros((b, k * cfg.shift_samples), np.int16), nv, zeros,
                active)
            self.state, _ = self.model.fused_tick_packed(
                cfg, self.state, self.model.put_batch(packed), active is None,
                phase=0, k=k, fast_gated=active is not None)
        self.state = self.model.realign_state(cfg, self.state, 1, half)
        self.state = self.model.compact_state(cfg, self.state, mask=half)
        self.state = reset_slots(self.state, np.ones(b, dtype=bool), self.hp)
        self.model.synchronize()
        self.phase = 0
        self.slot_phase[:] = 0

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
        self.state = reset_slots(self.state, mask, self.hp)
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

    def _prime_new_slots(self) -> None:
        """Fold each new stream's first 96 samples into its frontend carry."""
        rows = [i for i, s in enumerate(self.slots)
                if s is not None and not s.primed
                and s.staged >= PRIME_SAMPLES]
        if not rows:
            return
        mask = np.zeros(self.batch, dtype=bool)
        tails = np.zeros((self.batch, PP_TAIL_LEN), np.float32)
        lasts = np.zeros(self.batch, np.float32)
        for i in rows:
            tails[i], lasts[i] = prime_carry(self.slots[i].take(PRIME_SAMPLES))
            mask[i] = True
            self.slots[i].primed = True
        self.state = self.model.prime_frontend(self.state, mask, tails, lasts)

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
        """Process queued readbacks FIFO. A "tokens" entry is read once a
        newer step has been dispatched, when it is READBACK_DEPTH deep, or
        when force_all (idle ticks)."""
        events: list[Event] = []
        while self._pending_q:
            head = self._pending_q[0]
            if head.kind == "tokens" and head.result is None:
                has_newer = any(e.kind == "tokens"
                                for e in itertools.islice(self._pending_q, 1,
                                                          None))
                over_depth = len(self._pending_q) > READBACK_DEPTH
                if not (force_all or over_depth or has_newer):
                    break
            self._pending_q.popleft()
            if head.kind == "ended":
                slot = self.slots[head.slot_idx]
                events.append(Event(head.stream_id, "ended", ""))
                if slot is not None and slot.stream_id == head.stream_id:
                    self.release(head.slot_idx)
                continue
            t0 = time.perf_counter()
            if head.ready is not None:
                head.ready.synchronize()
            head.result = head.tokens_host.numpy()
            head.tokens_host = head.ready = None
            self.total_transfer_seconds += time.perf_counter() - t0
            t_sc = time.perf_counter()
            events.extend(self._process_pending(head))
            now = time.perf_counter()
            self.total_scatter_seconds += now - t_sc
            self.emit_latencies.append(now - head.t_dispatch)
        return events

    def _process_pending(self, pending: _Pending) -> list[Event]:
        """Scatter one step's tokens into the slots' transcripts."""
        tok_np = pending.result
        events: list[Event] = []
        for i in np.nonzero(pending.active)[0]:
            slot = self.slots[i]
            if slot is None or slot.stream_id != pending.stream_ids[i]:
                continue  # slot dropped / reused since dispatch
            emitted = tok_np[i]  # [T, S]
            ids = emitted[emitted >= 0].tolist()  # frame-major order
            text = self.model.tokenizer.decode(ids)
            slot.transcript += text
            if i in pending.finalizing:
                events.append(Event(slot.stream_id, "ended", text))
                self.release(i)
            elif text:
                events.append(Event(slot.stream_id, "text", text))
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
        older readbacks. Returns (events, more_work_pending)."""
        t_tick = time.perf_counter()
        cfg = self.cfg
        shift = cfg.shift_samples
        b = self.batch
        self.total_ticks += 1
        events: list[Event] = []

        self._apply_pending_drops()
        self._apply_pending_resets()
        self._drain_queues()
        self._prime_new_slots()

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
                # leftover frames beyond the steady chunks already dispatched
                left = (self._frames_total(slot)
                        - cfg.shift_mel_frames * slot.steps)
                nv = left // cfg.subsampling_factor if left > 0 else 0
                if nv > 0:
                    fin_nv[i] = nv
                else:
                    slot.finalize_sent = True
                    ended_now.append((i, slot.stream_id))

        # backlog micro-batching: every slot occupied, steady, and at least
        # k_cap chunks staged; starts only at phases divisible by k_cap
        k = 1
        k_cap = max_safe_tick_chunks(cfg.n_phases)
        if (k_cap > 1 and not fin_nv and not ended_now and bool(ready.all())
                and self.phase % k_cap == 0
                and min(s.staged // shift for s in self.slots) >= k_cap):
            k = k_cap

        block = np.zeros((b, k * shift), dtype=np.int16)
        for i in np.nonzero(ready)[0]:
            slot = self.slots[i]
            block[i] = slot.take(k * shift)
            n_valid[i] = cfg.valid_out_len
            active[i] = True
            slot.steps += k
        for i, nv in fin_nv.items():
            slot = self.slots[i]
            block[i, :shift] = slot.take(shift)  # zero-padded partial block
            n_valid[i] = nv
            active[i] = True
            finalizing.add(i)
            slot.finalize_sent = True

        if active.any():
            t0 = time.perf_counter()
            self.total_steps += 1
            self.total_chunk_steps += k
            n_act = int(active.sum())
            self.total_chunks += n_act * k
            self.total_audio_seconds += n_act * k * shift / cfg.sample_rate
            all_active = bool(active.all())
            # realign-on-resume: slots whose window fell behind the group
            # phase get one masked roll per distinct delta
            deltas: dict[int, list[int]] = {}
            for i in np.nonzero(active)[0]:
                d = self.phase - int(self.slot_phase[i])
                if d:
                    deltas.setdefault(d, []).append(i)
            for d, idxs in deltas.items():
                m = np.zeros(b, dtype=bool)
                m[idxs] = True
                self.state = self.model.realign_state(cfg, self.state, d, m)
                self.slot_phase[idxs] = self.phase
            stream_ids = np.full(b, -1, dtype=np.int64)
            for i in np.nonzero(active)[0]:
                stream_ids[i] = self.slots[i].stream_id

            t_pack = time.perf_counter()
            packed = self.model.pack_tick_inputs(
                block, n_valid, prompt_idx, None if all_active else active)
            self.total_pack_seconds += time.perf_counter() - t_pack
            t_up = time.perf_counter()
            packed_dev = self.model.put_batch(packed)
            self.total_upload_seconds += time.perf_counter() - t_up
            t_disp = time.perf_counter()
            self.state, tokens = self.model.fused_tick_packed(
                cfg, self.state, packed_dev, all_active, phase=self.phase,
                k=k, fast_gated=not all_active)
            self.total_dispatch_seconds += time.perf_counter() - t_disp
            entry = _Pending(
                kind="tokens", active=active, finalizing=finalizing,
                stream_ids=stream_ids, t_dispatch=time.perf_counter())
            self._start_readback(tokens, entry)

            if k > 1:  # wrap compaction already ran inside the k-chunk tick
                self.phase = (self.phase + k) % cfg.n_phases
                self.slot_phase[:] = self.phase
            else:
                self.slot_phase[active] = self.phase + 1
                self.phase += 1
                if self.phase >= cfg.n_phases:
                    aligned = self.slot_phase == cfg.n_phases
                    # paused slots' windows sit mid-buffer: the wrap must not
                    # clobber them (masked compaction)
                    self.state = self.model.compact_state(
                        cfg, self.state,
                        mask=None if bool(aligned.all()) else aligned)
                    self.slot_phase[aligned] = 0
                    self.phase = 0
            self._pending_q.append(entry)
            for i, sid in ended_now:
                self._pending_q.append(_Pending(
                    kind="ended", slot_idx=i, stream_id=sid))
            events.extend(self._drain_pending(force_all=False))
            self.total_step_seconds += time.perf_counter() - t0
        else:
            for i, sid in ended_now:
                self._pending_q.append(_Pending(
                    kind="ended", slot_idx=i, stream_id=sid))
            events.extend(self._drain_pending(force_all=True))

        more = bool(self._pending_q) or any(
            s is not None and not s.finalize_sent
            and ((s.primed and s.staged >= shift) or s.audio_queue
                 or s.ending)
            for s in self.slots)
        self.total_tick_seconds += time.perf_counter() - t_tick
        return events, more


class BatchedEngine:
    """Multi-latency-mode engine; owns one EngineGroup per right_context."""

    def __init__(self, model, batch_per_group: int = 32):
        if model.confidence:
            raise ValueError(
                "BatchedEngine: engine events do not unpack per-token "
                "confidences yet; build the model with confidence=False")
        self.model = model
        self.batch = batch_per_group
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
                    group = EngineGroup(self.model, self.model.cache_config(rc),
                                        self.batch)
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

    def transcript(self, stream_id: int) -> str:
        rc, slot = self._route[stream_id]
        s = self.groups[rc].slots[slot]
        return s.transcript if s else ""

    def stats(self) -> dict:
        """Engine counters per latency group (host clock, seconds)."""
        out = {"streams": len(self._route),
               "device": self.model.backend_name, "groups": {}}
        for rc, g in list(self.groups.items()):
            rtf = (g.total_step_seconds / g.total_audio_seconds
                   if g.total_audio_seconds else 0.0)
            out["groups"][rc] = {
                "active_slots": g.n_active_streams,
                "ticks": g.total_ticks,
                "steps": g.total_steps,
                "chunk_steps": g.total_chunk_steps,
                "chunks": g.total_chunks,
                "audio_seconds": round(g.total_audio_seconds, 2),
                "step_seconds": round(g.total_step_seconds, 3),
                "transfer_seconds": round(g.total_transfer_seconds, 3),
                "upload_seconds": round(g.total_upload_seconds, 3),
                "tick_seconds": round(g.total_tick_seconds, 3),
                "pack_seconds": round(g.total_pack_seconds, 3),
                "scatter_seconds": round(g.total_scatter_seconds, 3),
                "dispatch_seconds": round(g.total_dispatch_seconds, 3),
                "rtf": round(rtf, 5),
            }
            lat = np.asarray(list(g.emit_latencies)) * 1e3
            if lat.size:
                p50, p90, p99 = np.percentile(lat, (50, 90, 99))
                out["groups"][rc]["emit_latency_ms"] = {
                    "p50": round(float(p50), 1), "p90": round(float(p90), 1),
                    "p99": round(float(p99), 1), "n": int(lat.size)}
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
