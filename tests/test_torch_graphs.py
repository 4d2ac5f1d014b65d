"""The compiled tick on the CPU (nemotron_tpu_torch/graphs.py): the bodies
that the card captures as CUDA graphs, run here eagerly through the same
bookkeeping.

- The fixed-storage tick body against JAX's ASRModel.fused_tick_packed over
  one schedule in segments (as tests/test_torch_tick.py SEGMENTS): ticks
  across two wraps, a k=4 backlog tick with its wrap inside, a masked
  fast_gated tick with half the slots paused and their realign on resume,
  and a join (reset + prime_frontend). Tokens equal, leaves within 1e-4,
  and every state tensor keeps its data_ptr over the whole segment. The
  same for stream_step and for the two halves of fused_tick_profiled.
- No host sync: every graphed body runs under a TorchDispatchMode that
  raises on aten._local_scalar_dense, aten.nonzero, aten.is_nonzero and on
  any copy to the host, which is what a capture needs.
- The bookkeeping: after the same engine schedule the port's graph cache
  holds the tick keys of JAX's `_fn_cache`; `shard` clears it; a state
  with other storage captures its key anew and is counted.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from helpers import tiny_hparams
from test_torch_tick import assert_states_close

from nemotron_tpu.api import ASRModel as JaxModel
from nemotron_tpu.streaming.engine import BatchedEngine as JaxEngine
from nemotron_tpu.streaming.state import reset_slots as j_reset_slots
from nemotron_tpu_torch import graphs as graphs_mod
from nemotron_tpu_torch.api import ASRModel as TorchModel
from nemotron_tpu_torch.params import quantize_encoder_layers
from nemotron_tpu_torch.parallel.mesh import make_mesh
from nemotron_tpu_torch.streaming.engine import (PRIME_SAMPLES,
                                                 BatchedEngine, prime_carry)
from nemotron_tpu_torch.streaming.state import reset_slots, state_tensors

torch.set_num_threads(1)

B = 4
HALF = np.array([True, False, True, False])  # slots 1 and 3 paused


def make_audio(n, seed, b=B):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    out = np.empty((b, n), np.int16)
    for i in range(b):
        sig = (0.35 * np.sin(2 * np.pi * (210 + 60 * i) * t)
               + 0.2 * rng.standard_normal(n))
        out[i] = (np.clip(sig, -1, 1) * 32767).astype(np.int16)
    return out


def carries(audio):
    tails, lasts = zip(*(prime_carry(a[:PRIME_SAMPLES]) for a in audio))
    return np.stack(tails), np.asarray(lasts, np.float32)


def ptrs(state):
    return [t.data_ptr() for t in state_tensors(state)]


class Pair:
    """Both packages' B-stream states ticked through fused_tick_packed
    with the engine's phase bookkeeping; every port call is checked to
    return the caller's own state object, its storage unmoved."""

    def __init__(self, mode=0, phase=0, n_chunks=6, seed=3):
        hp = tiny_hparams()
        self.jm = JaxModel.random(hp, seed=1)
        self.tm = TorchModel.random(hp, seed=1, device="cpu")
        self.cfg = self.tm.cache_config(mode)
        self.audio = make_audio(PRIME_SAMPLES + n_chunks
                                * self.cfg.shift_samples, seed)
        self.pos = np.full(B, PRIME_SAMPLES)
        self.js = self.jm.init_stream_state(B, self.cfg)
        self.ts = self.tm.init_stream_state(B, self.cfg)
        self.ptrs = ptrs(self.ts)
        self.prime(np.ones(B, bool), *carries(self.audio))
        self.phase = phase
        self.slot_phase = np.full(B, phase)

    def _same(self, ts):
        assert ts is self.ts and ptrs(ts) == self.ptrs

    def prime(self, mask, tails, lasts):
        self.js = self.jm.prime_frontend(self.js, mask, tails, lasts)
        self._same(self.tm.prime_frontend(self.ts, mask, tails, lasts))

    def join(self, slot, seed):
        """A new stream in `slot`: reset, then its frontend carry."""
        mask = np.zeros(B, bool)
        mask[slot] = True
        self.js = j_reset_slots(self.js, mask, self.tm.hp)
        self._same(reset_slots(self.ts, mask, self.tm.hp))
        lo = self.pos[slot] - PRIME_SAMPLES  # its audio from here on
        self.audio[slot, lo:] = make_audio(self.audio.shape[1] - lo, seed,
                                           b=1)[0]
        tails, lasts = carries(self.audio[:, lo:])
        self.prime(mask, tails, lasts)
        self.slot_phase[slot] = self.phase

    def tick(self, k=1, active=None):
        cfg, shift = self.cfg, self.cfg.shift_samples
        act = np.ones(B, bool) if active is None else active
        for d in sorted({self.phase - p for p in self.slot_phase[act]} - {0}):
            m = act & (self.phase - self.slot_phase == d)  # realign on resume
            self.js = self.jm.realign_state(cfg, self.js, d, m)
            self.ts = self.tm.realign_state(cfg, self.ts, d, m)
            self._same(self.ts)
            self.slot_phase[m] = self.phase
        block = np.zeros((B, k * shift), np.int16)
        for i in np.nonzero(act)[0]:
            block[i] = self.audio[i, self.pos[i]:self.pos[i] + k * shift]
            self.pos[i] += k * shift
        packed = self.tm.pack_tick_inputs(
            block, np.where(act, cfg.valid_out_len, 0), np.zeros(B),
            None if active is None else act)
        self.js, jt = self.jm.fused_tick_packed(
            cfg, self.js, jnp.asarray(packed), active is None,
            phase=self.phase, k=k, fast_gated=active is not None)
        ts, tt = self.tm.fused_tick_packed(
            cfg, self.ts, self.tm.put_batch(packed), active is None,
            phase=self.phase, k=k, fast_gated=active is not None)
        self._same(ts)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        if k > 1:  # the wrap compaction ran inside
            self.phase = (self.phase + k) % cfg.n_phases
            self.slot_phase[:] = self.phase
            return
        self.slot_phase[act] = self.phase + 1
        self.phase += 1
        if self.phase == cfg.n_phases:
            aligned = self.slot_phase == cfg.n_phases
            mask = None if aligned.all() else aligned
            self.js = self.jm.compact_state(cfg, self.js, mask=mask)
            self.ts = self.tm.compact_state(cfg, self.ts, mask=mask)
            self._same(self.ts)
            self.slot_phase[aligned] = 0
            self.phase = 0

    def check(self, where):
        assert_states_close(self.js, self.ts, where)
        assert ptrs(self.ts) == self.ptrs, where


def _wraps(run):
    """R=13 (two phases): four ticks, across two wraps."""
    for _ in range(4):
        run.tick()
    assert run.phase == 0


def _backlog(run):
    """From phase 4: a k=4 tick (its wrap inside), then a single tick."""
    run.tick(k=4)
    assert run.phase == 0
    run.tick()


def _masked(run):
    """A tick, a masked fast_gated tick with half the slots paused, then
    all of them: the paused ones realigned by +1."""
    run.tick()
    run.tick(active=HALF)
    run.tick()


def _join(run):
    """A tick, then slot 2 takes a new stream (reset + prime_frontend),
    and a tick."""
    run.tick()
    run.join(2, seed=9)
    run.tick()


# name -> (right context, starting phase, segment)
SEGMENTS = {"wraps": (13, 0, _wraps), "backlog": (0, 4, _backlog),
            "masked": (0, 0, _masked), "join": (0, 0, _join)}


@pytest.mark.parametrize("name", list(SEGMENTS))
def test_fixed_storage_tick_matches_jax(name):
    mode, phase, seg = SEGMENTS[name]
    run = Pair(mode=mode, phase=phase)
    seg(run)
    run.check(f"after {name}")


def test_stream_step_keeps_storage_and_matches_jax():
    hp = tiny_hparams()
    jm = JaxModel.random(hp, seed=1)
    tm = TorchModel.random(hp, seed=1, device="cpu")
    cfg = tm.cache_config(0)
    js, ts = jm.init_stream_state(2, cfg), tm.init_stream_state(2, cfg)
    p0 = ptrs(ts)
    rng = np.random.default_rng(4)
    for phase, active in ((0, None), (1, None), (2, np.array([True, False]))):
        mel = rng.standard_normal((2, cfg.chunk_mel_frames, hp.n_mels)
                                  ).astype(np.float32)
        nv = np.full(2, cfg.valid_out_len, np.int32)
        js, jt = jm.stream_step(cfg, js, jnp.asarray(mel), jnp.asarray(nv),
                                None if active is None else
                                jnp.asarray(active), phase=phase)
        out, tt = tm.stream_step(cfg, ts, tm.put_batch(mel),
                                 tm.put_batch(nv),
                                 None if active is None
                                 else tm.put_batch(active), phase=phase)
        assert out is ts and ptrs(ts) == p0
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert_states_close(js, ts, "stream_step")


def test_profiled_halves_keep_storage_and_match_jax():
    hp = tiny_hparams()
    jm = JaxModel.random(hp, seed=1)
    tm = TorchModel.random(hp, seed=1, device="cpu")
    cfg = tm.cache_config(0)
    audio = make_audio(PRIME_SAMPLES + 3 * cfg.shift_samples, 6, b=2)
    js, ts = jm.init_stream_state(2, cfg), tm.init_stream_state(2, cfg)
    args = (np.ones(2, bool), *carries(audio))
    js, ts = jm.prime_frontend(js, *args), tm.prime_frontend(ts, *args)
    p0 = ptrs(ts)
    nv = np.full(2, cfg.valid_out_len, np.int32)
    prompt = np.zeros(2, np.int32)
    for i, active in enumerate((None, None, np.array([True, False]))):
        blk = audio[:, PRIME_SAMPLES + i * cfg.shift_samples:][
            :, :cfg.shift_samples]
        js, jt, _, _ = jm.fused_tick_profiled(
            cfg, js, jnp.asarray(blk), jnp.asarray(nv),
            None if active is None else jnp.asarray(active),
            jnp.asarray(prompt), phase=i if active is None else 0)
        out, tt, t_enc, t_dec = tm.fused_tick_profiled(
            cfg, ts, tm.put_batch(blk), tm.put_batch(nv),
            None if active is None else tm.put_batch(active),
            tm.put_batch(prompt), phase=i if active is None else 0)
        assert out is ts and ptrs(ts) == p0 and t_enc > 0 and t_dec > 0
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert_states_close(js, ts, "fused_tick_profiled")


# --- no host sync in any graphed body -----------------------------------

_SYNCS = (torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
          torch.ops.aten.is_nonzero, torch.ops.aten.item)
_COPIES = (torch.ops.aten._to_copy, torch.ops.aten.copy_,
           torch.ops.aten._copy_from, torch.ops.aten._copy_from_and_resize)


def _devices(xs):
    return {x.device for x in xs if isinstance(x, torch.Tensor)}


class NoHostSync(TorchDispatchMode):
    """Raises on an op that reads a device value on the host (a scalar
    read, nonzero, is_nonzero) and on any copy to the host from another
    device; records every op it saw."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        if func.overloadpacket in _SYNCS:
            raise AssertionError(f"host sync in a graphed body: {func}")
        if func.overloadpacket in _COPIES:
            dst = kwargs.get("device")
            src = _devices(args)
            if func.overloadpacket is not torch.ops.aten._to_copy:
                dst, src = args[0].device, _devices(args[1:])
            if dst is not None and torch.device(dst).type == "cpu" \
                    and any(d.type != "cpu" for d in src):
                raise AssertionError(f"copy to the host in a graphed body: "
                                     f"{func}")
        return func(*args, **kwargs)


def _sync_model(form):
    hp = tiny_hparams()
    kw = dict(kv_int8=form == "int8-kv", attn_block=form == "block")
    tm = TorchModel.random(hp, seed=1, device="cpu", **kw)
    if form == "q8":
        tm.params = quantize_encoder_layers(tm.params, bits=8)
    return tm


def _run_tick(tm, state, cfg, rng, k=1, active=None, fast_gated=True):
    blk = (rng.standard_normal((B, k * cfg.shift_samples)) * 3000
           ).astype(np.int16)
    packed = tm.put_batch(tm.pack_tick_inputs(
        blk, np.full(B, cfg.valid_out_len), np.zeros(B), active))
    return lambda: tm.fused_tick_packed(
        cfg, state, packed, active is None, phase=4 if k > 1 else 0, k=k,
        fast_gated=fast_gated)


def _body_calls(tm, body, mode):
    """The model call of one graphed body, ready to run twice (warm-up,
    then the checked call)."""
    cfg = tm.cache_config(mode)
    rng = np.random.default_rng(2)
    state = tm.init_stream_state(B, cfg)
    if body == "tick":
        return _run_tick(tm, state, cfg, rng)
    if body == "masked":
        return _run_tick(tm, state, cfg, rng, active=HALF)
    if body == "legacy":
        return _run_tick(tm, state, cfg, rng, active=HALF, fast_gated=False)
    if body == "backlog":
        return _run_tick(tm, state, cfg, rng, k=4)
    nv = tm.put_batch(np.full(B, cfg.valid_out_len, np.int32))
    prompt = tm.put_batch(np.zeros(B, np.int32))
    act = None if body.endswith("all") else tm.put_batch(HALF)
    if body.startswith("stream_step"):
        mel = tm.put_batch(rng.standard_normal(
            (B, cfg.chunk_mel_frames, tm.hp.n_mels)).astype(np.float32))
        return lambda: tm.stream_step(cfg, state, mel, nv, act, prompt)
    blk = tm.put_batch((rng.standard_normal((B, cfg.shift_samples))
                        * 3000).astype(np.int16))
    return lambda: tm.fused_tick_profiled(cfg, state, blk, nv, act, prompt)


SYNC_CASES = [("tick", "f32", 0), ("masked", "f32", 0),
              ("legacy", "f32", 0), ("backlog", "f32", 0),
              ("tick", "f32", 6), ("masked", "f32", 13),
              ("tick", "int8-kv", 0), ("masked", "int8-kv", 0),
              ("tick", "q8", 0), ("tick", "block", 0),
              ("stream_step_all", "f32", 0), ("stream_step_gated", "f32", 0),
              ("profiled_all", "f32", 0), ("profiled_gated", "f32", 0)]


@pytest.mark.parametrize("body, form, mode", SYNC_CASES,
                         ids=[f"{b}-{f}-r{m}" for b, f, m in SYNC_CASES])
def test_graphed_body_reads_nothing_back(body, form, mode):
    tm = _sync_model(form)
    call = _body_calls(tm, body, mode)
    call()  # the warm-up (it fills the constants' caches)
    with NoHostSync() as mode_:
        call()
    assert mode_.ops > 100  # the body ran under the mode


def test_no_host_sync_mode_catches_a_host_read():
    x = torch.arange(4)
    with pytest.raises(AssertionError, match="host sync"):
        with NoHostSync():
            int(x.sum())
    with pytest.raises(AssertionError, match="host sync"):
        with NoHostSync():
            torch.nonzero(x)


# --- the bookkeeping -------------------------------------------------------

TICK_KINDS = ("tick_packed", "stream_step", "fused_encode", "decode")


def _comparable(keys):
    """Tick keys with each CacheConfig as its field values; the port's
    decode key carries (cfg, batch) beyond JAX's (kind, all_active)."""
    out = set()
    for key in keys:
        if key[0] not in TICK_KINDS:
            continue
        if key[0] == "decode":
            out.add(key[:2])
            continue
        out.add(tuple(tuple(dataclasses.asdict(x).items())
                      if dataclasses.is_dataclass(x) else x for x in key))
    return out


def _drive(engine, schedule, audios, shift=1280):
    """Per round, stream i pushes schedule[round][i] chunks (its first
    push with the priming samples), then one tick; then every stream
    ends and the engine ticks until idle."""
    sids = [None] * len(audios)
    pos = [0] * len(audios)
    for rnd in schedule:
        for i, n in enumerate(rnd):
            if not n:
                continue
            if sids[i] is None:
                sids[i] = engine.start_stream(0)
            end = pos[i] + n * shift + (PRIME_SAMPLES if not pos[i] else 0)
            engine.push_audio(sids[i], audios[i][pos[i]:end])
            pos[i] = end
        engine.tick()
    for sid in sids:
        engine.end_stream(sid)
    for _ in range(50):
        if not engine.tick()[1]:
            return
    raise AssertionError("engine did not go idle")


def test_engine_schedule_leaves_the_jax_tick_keys():
    hp = tiny_hparams()
    jm = JaxModel.random(hp, seed=1)
    tm = TorchModel.random(hp, seed=1, device="cpu")
    audios = list(make_audio(PRIME_SAMPLES + 6 * 1280, 8, b=2))
    schedule = [(1, 0), (1, 1), (0, 1), (1, 1)]
    _drive(JaxEngine(jm, batch_per_group=2), schedule, audios)
    _drive(BatchedEngine(tm, batch_per_group=2), schedule, audios)
    want = _comparable(jm._fn_cache)
    assert len(want) >= 3  # all-active and masked ticks at several phases
    assert _comparable(tm.graphs.keys()) == want


def test_shard_clears_the_graphs():
    tm = TorchModel.random(tiny_hparams(), seed=1, device="cpu")
    cfg = tm.cache_config(0)
    _run_tick(tm, tm.init_stream_state(B, cfg), cfg,
              np.random.default_rng(0))()
    assert tm.graphs.keys()
    tm.shard(make_mesh(1, 1, devices=["cpu"]))
    assert not tm.graphs.keys() and not tm.graphs.entries


def test_other_storage_recaptures_its_key(monkeypatch):
    """The cache's decisions on the card, with its three device steps
    stubbed (the CPU cannot capture): warm-up, then capture, then replay;
    a state with other storage captures the key again and is counted."""
    cache = graphs_mod.GraphCache()
    done = []

    def warm(entry, device, body, state, inputs):
        done.append("warm")
        entry.outputs_meta = []
        return ()

    def capture(key, entry, device, body, state, inputs, p):
        done.append("capture")
        entry.graph, entry.ptrs = object(), p
        entry.captures += 1

    monkeypatch.setattr(cache, "_warm_up", warm)
    monkeypatch.setattr(cache, "_capture", capture)
    monkeypatch.setattr(cache, "_replay",
                        lambda entry, inputs: done.append("replay") or ())
    tm = TorchModel.random(tiny_hparams(), seed=1, device="cpu")
    cfg = tm.cache_config(0)
    a, b = tm.init_stream_state(2, cfg), tm.init_stream_state(2, cfg)
    cuda = torch.device("cuda")
    for state in (a, a, a, b, b, a):
        cache.run(("k",), 0, cuda, None, state, ())
    assert done == ["warm", "capture", "replay", "replay", "capture",
                    "replay", "replay", "capture", "replay"]
    stats = cache.stats()
    assert stats["recaptures"] == 2 and stats["captures"] == 3
    assert cache.keys() == {("k",)}
    cache.run(("k",), 0, torch.device("cpu"), lambda s: (), a, ())
    assert len(done) == 9  # the CPU runs the body eagerly


@pytest.mark.parametrize("enabled", [True, False])
def test_captures_pause_the_garbage_collector(enabled):
    """The collector is off while any capture runs, nested or on two
    threads at once, and back as it was once the last one ends."""
    import gc
    import threading

    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        inner, seen = threading.Event(), []

        def other():
            with graphs_mod._gc_paused():
                inner.set()
                seen.append(gc.isenabled())

        with graphs_mod._gc_paused():
            with graphs_mod._gc_paused():
                seen.append(gc.isenabled())
            t = threading.Thread(target=other)
            t.start()
            inner.wait(5)
            t.join(5)
            seen.append(gc.isenabled())
        assert seen == [False, False, False]
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()


def test_graph_turns_schedule_runs_every_tick_key():
    """tools/graph_turns.run_schedule, which phase 10 of chip_smoke.py and
    the GPU tests run graphed against eager: on the CPU both models run
    the bodies eagerly and agree; the schedule reaches the 11 tick keys
    of R=0 (every phase, the k=4 backlog at phases 0 and 4, the masked
    tick) three times each, over 78 ticks, and the four keys of the slot
    operations between them (the prime, the reset, the wrap's compaction,
    the realign by +1) at least three times each."""
    from nemotron_tpu_torch.tools.graph_turns import compare, run_schedule

    a = TorchModel.random(tiny_hparams(), seed=1, device="cpu")
    b = TorchModel(a.hp, a.params, a.tokenizer.vocab, device="cpu",
                   graphs=False)
    tok_a, st_a = run_schedule(a, B, 0)
    tok_b, st_b = run_schedule(b, B, 0)
    assert len(tok_a) == 78
    assert all(np.array_equal(x, y) for x, y in zip(tok_a, tok_b))
    assert compare(st_a, st_b)["equal"]
    stats = a.graphs.stats(lambda key: key[0] == "tick_packed")
    assert stats["keys"] == 11 and stats["calls"] == 78
    cfg = a.cache_config(0)
    calls = {key: e.calls for (key, _), e in a.graphs.entries.items()
             if key[0] != "tick_packed"}
    assert calls == {("prime", cfg): 4, ("reset", cfg): 3,
                     ("compact", cfg, cfg.n_phases, False): 9,
                     ("realign", cfg, 1): 3}
    assert all(e.calls >= 3 for e in a.graphs.entries.values())
