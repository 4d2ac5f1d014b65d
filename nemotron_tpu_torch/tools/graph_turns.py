"""The compiled tick's schedule and an engine under churn, graphed against
eager on the card (chip_smoke.py phase 10 and tests/test_torch_gpu.py
run them), and the churn of two or more checkouts in turns.

`run_schedule(model, batch, mode)` drives `ASRModel.fused_tick_packed` as
the engine does (on one device or on a mesh: a model after
`ASRModel.shard`, and its eager `twin`), over `passes` passes of one schedule from a primed
state: every phase of a cycle all-active (through the wrap), the backlog
ticks (k = 4 chunks, or k = n_phases below 4 phases; the last one's wrap
inside), a masked fast_gated tick with every other slot paused and the
rest of its cycle all-active (the paused slots realigned on resume), and a
join (a slot reset and primed with a new stream's carry) followed by a
cycle. On a graphed model the first pass warms each key up, the second
captures it and the third replays; with `sync_debug` the whole last pass
(the uploads, the ticks and the slot operations between them) runs under
`torch.cuda.set_sync_debug_mode("error")`. The audio of each tick is
drawn from `seed`, so two models see the same inputs.

`Churn(model, batch, mode)` is a BatchedEngine (one group at right context
`mode`, prewarmed) fed by a deterministic schedule, one engine tick per
`step()`: streams join into the slots that ended streams leave; a quarter
of them (every fourth stream) pause for 1 to PAUSE_MAX ticks at random and
resume (realigned at deltas of 1-7 phases at right context 0), so wraps
find paused slots (masked compactions); whenever the group is at phase 0
and BURST_EVERY ticks have passed, every stream pushes k_cap chunks at
once and then holds (a backlog tick of k_cap chunks; no stream ends in
the FREEZE ticks before a burst is due, so every slot is ready for it).
The schedule reads nothing but the engine's own flow (its phase, its free
slots), so two engines of the same flow (graphed and eager, or two
checkouts) run the same ticks, and a graphed and an eager run give the
same texts and states. Its rates (PAUSE_P, PAUSE_MAX, BURST_EVERY,
STREAM_CHUNKS: about 2.8 joins a tick at B=256, R=0) are this tool's
choice, made to reach every slot operation often, not a measured traffic
mix: a total per tick holds for this schedule only. `churn_measure`
times it: host ms per engine tick, the device's idle share (device time
per chunk step from a profiled window), synchronising CUDA calls per 100
ticks (`set_sync_debug_mode("warn")`, counted, with their sites and the
slot operation they fell in), emit latency p50 / p99 from `stats()`, the
host's split of a tick (the engine's timers and the slot operations' own
host time), the slot operations' graph keys, and what carries over to
any mix: each kind of slot operation's cost per call (SlotOps: calls,
slots per call, host ms, the stream's ms across the call, syncs).

In turns, each tree in a process of its own (it builds its own kernels;
tools/turns.py):

    python3 nemotron_tpu_torch/tools/graph_turns.py \\
        --tree parent=_archive/parent --tree change=. \\
        --tree change=. --tree parent=_archive/parent \\
        [--depth 2 --depth 1] --json churn.json

runs CHURN_CONFIGS (B=256: R=0 bf16 int8 K/V, R=13 bf16; random weights
from seed 0, graphed ticks) in every tree, at each engine readback depth
given. The trees are imported by path, so this file imports the package
only inside its functions.

`compare(a, b)` holds two states leaf by leaf.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

try:
    from . import turns
except ImportError:  # run as a script: this directory leads the path
    import turns

SLOT_KEYS = ("prime", "reset", "compact", "realign")  # graphs.py key kinds
CHURN_B = 256
CHURN_SEED = 0
BLANK_BIAS = 2.4  # chip_smoke.py's: the random weights emit
PACED_EVERY = 4   # every fourth stream pauses now and then
PAUSE_P = 0.15    # a paced stream's chance per tick of starting a pause
PAUSE_MAX = 7     # ticks a pause lasts, at most
BURST_EVERY = 32  # ticks between backlog bursts, at least
FREEZE = 8        # ticks before a due burst in which no stream ends
STREAM_CHUNKS = (24, 160)  # a stream's length in chunks, drawn
CLIPS = 16
# (name, activation type, int8 K/V, right context, (warm-up, timed,
# profiled, counted) ticks)
CHURN_CONFIGS = (("bf16 int8-KV", "bf16", True, 0, (64, 256, 96, 100)),
                 ("bf16", "bf16", False, 13, (16, 64, 24, 25)))


def _carries(rng, b: int):
    from nemotron_tpu_torch.streaming.engine import PRIME_SAMPLES, prime_carry

    raw = (rng.standard_normal((b, PRIME_SAMPLES)) * 3000).astype(np.int16)
    tails, lasts = zip(*(prime_carry(r) for r in raw))
    return np.stack(tails), np.asarray(lasts, np.float32)


@contextlib.contextmanager
def _sync_errors(on: bool):
    if not on:
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def twin(model, graphs: bool = False):
    """A model on `model`'s weights and options, and on its mesh where it
    has one (its own placement and tp rank streams), with its own graph
    cache: eager (graphs False), or graphed from a clean cache."""
    from nemotron_tpu_torch.api import ASRModel

    other = ASRModel(model.hp, model.params, model.tokenizer.vocab,
                     device=model.device,
                     kv_int8=model.kv_int8, attn_block=model.attn_block,
                     confidence=model.confidence, graphs=graphs)
    return other if model.mesh is None else other.shard(model.mesh)


def run_schedule(model, batch: int, mode: int = 0, passes: int = 3,
                 seed: int = 0, sync_debug: bool = False):
    """The schedule of the module docstring on a fresh state. Returns
    (the tokens of every tick as host arrays, the final state)."""
    cfg = model.cache_config(mode)
    n = cfg.n_phases
    k = 4 if n % 4 == 0 else n
    rng = np.random.default_rng(seed)
    state = model.init_stream_state(batch, cfg)
    state = model.prime_frontend(state, np.ones(batch, bool),
                                 *_carries(rng, batch), cfg=cfg)
    half = np.arange(batch) % 2 == 0  # odd slots paused
    toks = []

    def tick(k=1, phase=0, active=None):
        nonlocal state
        audio = (rng.standard_normal((batch, k * cfg.shift_samples)) * 3000
                 ).astype(np.int16)
        packed = model.put_batch(model.pack_tick_inputs(
            audio, np.full(batch, cfg.valid_out_len), np.zeros(batch),
            active))
        state, tokens = model.fused_tick_packed(
            cfg, state, packed, active is None, phase=phase, k=k,
            fast_gated=True)
        # the tokens leave the static output before the next replay
        host = torch.empty(tokens.shape, dtype=tokens.dtype,
                           pin_memory=tokens.is_cuda)
        toks.append(host.copy_(tokens, non_blocking=True))

    def cycle(start=0):
        nonlocal state
        for phase in range(start, n):
            tick(phase=phase)
        state = model.compact_state(cfg, state)

    for p in range(passes):
        with _sync_errors(sync_debug and p == passes - 1):
            cycle()
            for phase in range(0, n, k):  # the backlog; the last wraps
                tick(k=k, phase=phase)
            tick(phase=0, active=half)  # odd slots paused
            # they resume one phase behind: realign +1
            state = model.realign_state(cfg, state, 1, ~half)
            cycle(start=1)
            join = np.zeros(batch, bool)
            join[1] = True  # a new stream in slot 1
            state = model.reset_state(state, join, cfg=cfg)
            state = model.prime_frontend(state, join, *_carries(rng, batch),
                                         cfg=cfg)
            cycle()
    model.synchronize()
    return [t.numpy() for t in toks], state


def join_in_turns(engine, right_contexts, joins: int,
                  seed: int = 0) -> None:
    """`joins` streams joining `engine`'s groups (one per right context,
    prewarmed) in turn, each pushing its prime and two chunks before an
    engine tick: every tick resets and primes one group's slots between
    the other groups' (so a slot key shared by groups would be captured
    again at every join). `joins` at most the groups' batch each."""
    from nemotron_tpu_torch.streaming.engine import PRIME_SAMPLES

    rng = np.random.default_rng(seed)
    for j in range(joins * len(right_contexts)):
        rc = right_contexts[j % len(right_contexts)]
        sid = engine.start_stream(rc)
        n = PRIME_SAMPLES + 2 * engine.groups[rc].cfg.shift_samples
        engine.push_audio(sid, (rng.standard_normal(n) * 3000).astype(
            np.int16))
        engine.tick()
    engine.model.synchronize()


def compare(a, b) -> dict:
    """Leaf by leaf (state_leaves order): {"equal": all bit-equal,
    "max_abs": the largest |a - b| over the leaves as f32, "leaves": how
    many}."""
    from nemotron_tpu_torch.streaming.state import state_leaves

    la, lb = state_leaves(a), state_leaves(b)
    eq = all(torch.equal(x, y) for x, y in zip(la, lb))
    diff = max(float((x.float() - y.float()).abs().max()) if x.numel()
               else 0.0 for x, y in zip(la, lb))
    return {"equal": eq, "max_abs": diff, "leaves": len(la)}


class Churn:
    """The engine under churn of the module docstring."""

    def __init__(self, model, batch: int = CHURN_B, mode: int = 0,
                 seed: int = CHURN_SEED, readback_depth: int | None = None):
        from nemotron_tpu_torch.streaming.engine import (
            PRIME_SAMPLES, BatchedEngine, max_safe_tick_chunks)

        self.model, self.batch, self.mode = model, batch, mode
        self.engine = BatchedEngine(
            model, batch_per_group=batch,
            **({} if readback_depth is None
               else {"readback_depth": readback_depth}))
        self.engine.prewarm(right_contexts=(mode,))
        self.group = self.engine.groups[mode]
        cfg = self.group.cfg
        self.shift = cfg.shift_samples
        self.k_cap = max_safe_tick_chunks(cfg.n_phases)
        self.prime = PRIME_SAMPLES
        self.rng = np.random.default_rng(seed)
        # a stream runs past its length through a freeze and a burst
        n = PRIME_SAMPLES + (STREAM_CHUNKS[1] + 2 * BURST_EVERY) * self.shift
        t = np.arange(n) / 16000.0
        self.clips = []
        for c in range(CLIPS):  # a tone under noise per clip
            sig = (0.4 * np.sin(2 * np.pi * (180 + 37 * c) * t)
                   + 0.2 * self.rng.standard_normal(n))
            self.clips.append((np.clip(sig, -1, 1) * 32767).astype(np.int16))
        self.streams: dict = {}  # stream id -> its schedule
        self.texts: dict = {}    # stream id -> its text so far
        self.waiting = batch     # streams to start
        self.t = 0
        self.hold = 0            # ticks left of a burst's hold
        self.next_burst = BURST_EVERY
        self.joined = self.ended = self.bursts = 0
        self.dispatched: list[bool] = []

    def _push(self, sid: int, s: dict, n: int) -> None:
        a = self.clips[s["clip"]][s["pos"]:s["pos"] + n]
        s["pos"] += n
        self.engine.push_audio(sid, a)

    def _join(self) -> None:
        while self.waiting and self.group.n_active_streams < self.batch:
            sid = self.engine.start_stream(self.mode)
            length = int(self.rng.integers(*STREAM_CHUNKS))
            s = {"clip": sid % CLIPS, "pos": 0, "left": length,
                 "paced": sid % PACED_EVERY == 0, "until": 0,
                 "ending": False}
            self.streams[sid] = s
            self._push(sid, s, self.prime)
            self.waiting -= 1
            self.joined += 1

    def step(self) -> float:
        """One tick's audio, then one engine tick; returns the host
        seconds of engine.tick()."""
        self._join()
        burst = (self.hold == 0 and self.t >= self.next_burst
                 and self.group.phase == 0)
        # no stream ends just before a burst or at it: a finalizing slot
        # is not ready, and a backlog tick needs every slot ready
        freeze = burst or self.t >= self.next_burst - FREEZE
        if burst:
            self.hold = self.k_cap
            self.next_burst = self.t + BURST_EVERY
            self.bursts += 1
        for sid, s in self.streams.items():
            if s["ending"]:
                continue  # its events still to come
            if burst:
                s["until"], n = 0, self.k_cap
            elif self.hold or self.t < s["until"]:
                n = 0
            elif s["paced"] and self.rng.random() < PAUSE_P:
                s["until"] = self.t + 1 + int(self.rng.integers(PAUSE_MAX))
                n = 0
            else:
                n = 1
            if n:
                self._push(sid, s, n * self.shift)
                s["left"] -= n
            if s["left"] <= 0 and not freeze:
                self.engine.end_stream(sid)
                s["ending"] = True
                self.waiting += 1
        self.hold = max(0, self.hold - 1)
        steps = self.group.total_steps
        t0 = time.perf_counter()
        events, _ = self.engine.tick()
        dt = time.perf_counter() - t0
        self.dispatched.append(self.group.total_steps > steps)
        for e in events:
            self.texts[e.stream_id] = self.texts.get(e.stream_id, "") + e.text
            if e.kind == "ended":
                self.streams.pop(e.stream_id, None)
                self.ended += 1
        self.t += 1
        return dt

    def run(self, n: int) -> list[float]:
        return [self.step() for _ in range(n)]

    def slot_graphs(self) -> dict:
        """The slot operations' graph keys (none where they run eagerly):
        keys, captures, replays, pool MB, capture seconds."""
        gs = self.model.graphs.stats(lambda key: key[0] in SLOT_KEYS)
        return {"keys": gs["keys"], "calls": gs["calls"],
                "captures": gs["captures"], "recaptures": gs["recaptures"],
                "replays": gs["replays"],
                "pool_MB": round(gs["pool_bytes"] / 2 ** 20, 3),
                "capture_s": round(gs["capture_seconds"], 4)}


def count_syncs(fn, kind=None, by_kind: dict | None = None) -> tuple:
    """(fn()'s result, the synchronising CUDA calls it made, {site: count}):
    calls under set_sync_debug_mode("warn"), each warning counted at the
    innermost frame of the package that made it ("file:line function").
    With `kind` (a callable), each is also counted in by_kind under
    kind()."""
    import traceback

    sites: dict = {}

    def seen(message, category, filename, lineno, file=None, line=None):
        # not the mode's own notice ("Synchronization debug mode is a
        # prototype feature ...")
        if "called a synchronizing CUDA operation" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "nemotron_tpu_torch" in f.filename]
        f = frames[-1] if frames else None
        site = (f"{Path(f.filename).name}:{f.lineno} {f.name}" if f
                else "outside the package")
        sites[site] = sites.get(site, 0) + 1
        if kind is not None:
            k = kind()
            by_kind[k] = by_kind.get(k, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(sites.values()), sites


# the slot operations' methods (the parent's engine reset by reset_slots)
SLOT_METHODS = ("prime_frontend", "reset_state", "compact_state",
                "realign_state")


class SlotOps:
    """Wraps the slot operations of `model` (and reset_slots where an
    engine module calls it itself, as the parent's did) while it is
    entered, and keeps per kind (prime, reset, realign, "compact masked",
    "compact": the unmasked wrap): calls, the slots their masks select
    (all `batch` for the wrap), host seconds (a call that syncs includes
    its wait) and a CUDA event before and after each call (the stream's
    time across the call: the device's work, plus any wait for the host
    inside the call). `kind` is the kind running, "tick" between calls.
    These per-call costs carry over to any traffic mix: a join is a
    reset and a prime (one each per tick with joins), a resume a realign
    per distinct delta, a paused slot at a wrap a masked compaction."""

    def __init__(self, model, batch: int):
        import nemotron_tpu_torch.streaming.engine as eng

        self.model, self.batch, self.eng = model, batch, eng
        self.kind = "tick"
        self.rows: dict = {}  # kind -> [calls, slots, host s, events]

    def _wrap(self, fn, name: str):
        import inspect

        sig = inspect.signature(fn)

        def call(*a, **kw):
            mask = sig.bind(*a, **kw).arguments.get("mask")
            kind = {"prime_frontend": "prime", "reset_state": "reset",
                    "reset_slots": "reset", "realign_state": "realign",
                    "compact_state": "compact masked" if mask is not None
                    else "compact"}[name]
            row = self.rows.setdefault(kind, [0, 0, 0.0, []])
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            self.kind = kind
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                row[2] += time.perf_counter() - t0
                self.kind = "tick"
                ev[1].record()
                row[0] += 1
                row[1] += (self.batch if mask is None
                           else int(np.count_nonzero(np.asarray(mask))))
                row[3].append(ev)
        return call

    def __enter__(self):
        for n in SLOT_METHODS:
            if hasattr(self.model, n):
                setattr(self.model, n, self._wrap(getattr(self.model, n), n))
        self.own = getattr(self.eng, "reset_slots", None)
        if self.own is not None:
            self.eng.reset_slots = self._wrap(self.own, "reset_slots")
        return self

    def __exit__(self, *exc):
        for n in SLOT_METHODS:
            self.model.__dict__.pop(n, None)
        if self.own is not None:
            self.eng.reset_slots = self.own

    def host_seconds(self) -> float:
        return sum(r[2] for r in self.rows.values())

    def table(self, syncs: dict | None = None, sync_calls=None) -> dict:
        """Per kind: calls, slots per call, host ms per call, stream ms per
        call (median and mean; the window synchronised first), and with
        `syncs` (by kind, from a counted window whose SlotOps is
        `sync_calls`) syncs per call."""
        out = {}
        for kind, (n, slots, host, evs) in sorted(self.rows.items()):
            ms = [a.elapsed_time(b) for a, b in evs]
            out[kind] = {"calls": n, "slots_per_call": round(slots / n, 2),
                         "host_ms_per_call": round(host / n * 1e3, 4),
                         "stream_ms_median": round(statistics.median(ms), 4),
                         "stream_ms_mean": round(statistics.mean(ms), 4)}
            if syncs is not None:
                calls = sync_calls.rows.get(kind, [0])[0]
                out[kind]["syncs_per_call"] = (
                    round(syncs.get(kind, 0) / calls, 2) if calls else None)
        return out


@contextlib.contextmanager
def slot_ops_sync_errors(model):
    """Each slot operation of `model` (prime, reset, compact, realign)
    called under set_sync_debug_mode("error"): a synchronising CUDA call
    inside one raises."""
    for name in SLOT_METHODS:
        fn = getattr(model, name)

        def checked(*a, fn=fn, **kw):
            with _sync_errors(True):
                return fn(*a, **kw)
        setattr(model, name, checked)
    try:
        yield
    finally:
        for name in SLOT_METHODS:
            delattr(model, name)


def churn_measure(model, batch: int, mode: int, windows,
                  readback_depth: int | None = None) -> dict:
    """A Churn on `model` (its engine at `readback_depth`, the engine's
    default if None), measured over its windows of ticks (warm-up, timed,
    profiled, counted; see the module docstring). The device's busy time
    comes from the profiled window (torch.profiler, CUDA activity only:
    its own host cost inflates that window's wall time, so the timed
    window runs without it) per chunk step, which a backlog tick has k
    of, times the timed window's chunk steps; the idle share sets that
    against the timed window's wall time. `slot_ops` gives each kind of
    slot operation's own cost per call (SlotOps: timed window; syncs from
    the counted one), which carries over to other mixes of joins, pauses
    and wraps than this schedule's."""
    from torch.profiler import ProfilerActivity, profile

    warm, n_time, n_prof, n_count = windows
    t0 = time.perf_counter()
    ch = Churn(model, batch, mode, readback_depth=readback_depth)
    prewarm_s = time.perf_counter() - t0
    ch.run(warm)
    torch.cuda.synchronize()
    ch.group.emit_latencies.clear()
    first = len(ch.dispatched)
    # the engine's span of each part (utils/trace.py)
    parts = {"transfer": "engine.readback_wait", "scatter": "engine.scatter",
             "dispatch": "engine.dispatch", "pack": "engine.pack",
             "upload": "engine.upload"}
    secs = ch.group.spans.seconds
    before = {k: secs[span] for k, span in parts.items()}
    steps0 = ch.group.total_chunk_steps
    joined0 = ch.joined
    with SlotOps(model, batch) as ops:
        t0 = time.perf_counter()
        host = ch.run(n_time)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps_t = ch.group.total_chunk_steps - steps0
    joins_t = ch.joined - joined0
    # the engine's own split of a tick's host time (ms per tick):
    # transfer is the wait on a token readback, the rest host work
    split = {k: round((secs[span] - before[k]) / n_time * 1e3, 3)
             for k, span in parts.items()}
    split["slot_ops"] = round(ops.host_seconds() / n_time * 1e3, 3)
    disp = [h for h, d in zip(host, ch.dispatched[first:]) if d]
    lat = ch.engine.stats()["groups"][mode].get("emit_latency_ms", {})
    steps0 = ch.group.total_chunk_steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ch.run(n_prof)
        torch.cuda.synchronize()
    busy = turns.busy_ms(prof)
    steps_p = ch.group.total_chunk_steps - steps0
    by_kind: dict = {}
    with SlotOps(model, batch) as counted:
        _, syncs, sites = count_syncs(lambda: ch.run(n_count),
                                      lambda: counted.kind, by_kind)
        torch.cuda.synchronize()
    wall_ms = wall / n_time * 1e3
    busy_ms = (None if busy is None or not steps_p
               else busy / steps_p * steps_t / n_time)
    return {
        "readback_depth": ch.engine.readback_depth,
        "ticks": ch.t, "prewarm_s": round(prewarm_s, 3),
        "host_ms_median": round(statistics.median(disp) * 1e3, 3),
        "host_ms_mean": round(statistics.mean(disp) * 1e3, 3),
        "wall_ms_per_tick": round(wall_ms, 3),
        "dispatch_share": round(len(disp) / n_time, 3),
        "chunk_steps": [steps_t, steps_p],
        "busy_ms_per_tick": None if busy_ms is None else round(busy_ms, 3),
        "idle": None if busy_ms is None else round(max(
            0.0, 1 - busy_ms / wall_ms), 3),
        "syncs_per_100": round(100.0 * syncs / n_count, 1),
        "sync_sites": dict(sorted(sites.items(), key=lambda kv: -kv[1])),
        "syncs_by_kind": by_kind,
        "host_split_ms": split,
        "slot_ops": ops.table(by_kind, counted),
        "timed_window": {"ticks": n_time, "joins": joins_t},
        "emit_p50_ms": lat.get("p50"), "emit_p99_ms": lat.get("p99"),
        "emits": lat.get("n"),
        "joins": ch.joined, "bursts": ch.bursts,
        "backlog_chunks": ch.group.total_chunk_steps - ch.group.total_steps,
        "slot_graphs": ch.slot_graphs(),
        "tick_graphs": {k: v for k, v in model.graphs.stats(
            lambda key: key[0] == "tick_packed").items()
            if k in ("keys", "captures", "replays")}}


def child(tree: str, depths) -> None:
    """Runs inside `tree`: CHURN_CONFIGS on its package, at each readback
    depth of `depths` (the engine's default if empty); one JSON line."""
    turns.enter(tree)
    from nemotron_tpu_torch import Hparams
    from nemotron_tpu_torch.api import ASRModel

    rows = []
    for name, dt, int8, mode, windows in CHURN_CONFIGS:
        for depth in depths or (None,):
            model = ASRModel.random(
                Hparams(), seed=0, device="cuda", kv_int8=int8,
                dtype=torch.bfloat16 if dt == "bf16" else torch.float32)
            model.params.joint.out_b[model.hp.blank_id] += BLANK_BIAS
            rows.append({"config": name, "B": CHURN_B, "R": mode,
                         **churn_measure(model, CHURN_B, mode, windows,
                                         depth)})
            del model
            torch.cuda.empty_cache()
    print(json.dumps({"rows": rows}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="label=path, in the order to run")
    ap.add_argument("--depth", action="append", type=int, default=[],
                    help="the engine's readback depth (each given, in "
                    "order; default: the engine's own)")
    ap.add_argument("--json", help="write every run's rows here as JSON")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.depth)
        return 0
    card = turns.card()
    print(card, flush=True)
    out = []
    for label, path in (t.split("=", 1) for t in args.tree):
        got = turns.run_child(__file__, label, path,
                              [f"--depth={d}" for d in args.depth],
                              timeout=1200)
        if got is None:
            return 1
        out.append(dict(label=label, path=path, **got))
        for r in got["rows"]:
            print(f"{label}: churn {r['config']} B={r['B']} R={r['R']}: "
                  f"{json.dumps(r)} ({card})", flush=True)
    turns.write_json(args.json, card, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
