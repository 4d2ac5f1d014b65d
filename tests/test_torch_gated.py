"""The legacy gated flow and the phase timers against the JAX package, on
the same random tiny weights (tests/helpers.tiny_hparams, seed 1):

  - the phase-stationary gated step (ASRModel.stream_step with an active
    mask) and the fused tick's legacy gated form (fused_tick_packed,
    fast_gated=False) between all-active steps, across a wrap: tokens equal,
    f32 state leaves within 1e-4 (int8 K/V codes within 1 and their scales
    within 1e-4 relative), bf16 under the port's bf16 rule (the step only),
    paused slots bit for bit untouched;
  - BatchedEngine(gated_realign=False) and BatchedEngine(phase_timers=True)
    under a staggered join / pause / end schedule: the same events as the
    JAX engine with NEMOTRON_TPU_GATED_REALIGN=0 / NEMOTRON_TPU_PHASE_TIMERS=1
    (tests/test_engine.py:test_engine_phase_timers is the JAX counterpart),
    and stats() carrying encoder_seconds / decoder_seconds;
  - BatchedEngine(readback_depth=, max_tick_chunks=) against the JAX engine
    under NEMOTRON_TPU_READBACK_DEPTH / NEMOTRON_TPU_MAX_TICK_CHUNKS (one
    readback deep, no k-chunk ticks; three deep with k <= 2; 0 and 0
    clamped to 1), and the
    server's main mapping the four variables onto the engine's arguments.

Everything runs right context 0 with N_PHASES slack-buffer phases (the JAX
package compiles a step per phase and mask)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_hparams

from nemotron_tpu.api import ASRModel as JaxModel
from nemotron_tpu.config import CacheConfig as JaxCacheConfig
from nemotron_tpu.streaming import engine as jax_engine
from nemotron_tpu_torch.api import ASRModel as TorchModel
from nemotron_tpu_torch.config import CacheConfig
from nemotron_tpu_torch.ops.kvquant import is_quant
from nemotron_tpu_torch.streaming.engine import (PRIME_SAMPLES,
                                                 BatchedEngine, prime_carry)
from nemotron_tpu_torch.streaming.state import state_leaves

torch.set_num_threads(1)

N_PHASES = 2
ATOL = 1e-4
BF16_REL = 2.0 ** -5  # 4 bf16 ulps at the leaf's largest magnitude


@pytest.fixture(scope="module", autouse=True)
def few_phases():
    mp = pytest.MonkeyPatch()
    for cls in (JaxCacheConfig, CacheConfig):
        mp.setitem(cls._MODE_N_PHASES, 0, N_PHASES)
    yield
    mp.undo()


def make_audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = 0.4 * np.sin(2 * np.pi * (210 + 35 * seed) * t) \
        + 0.2 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


def jax_model(kv_int8=False, bf16=False):
    mp = pytest.MonkeyPatch()
    mp.setenv("NEMOTRON_TPU_KV_INT8", "1" if kv_int8 else "0")
    return JaxModel.random(tiny_hparams(), seed=1,
                           dtype=jnp.bfloat16 if bf16 else jnp.float32), mp


def check_states(t_state, j_state, paused=None, before=None):
    """Port state vs JAX state leaf by leaf (state_leaves' order is the JAX
    pytree's); paused rows equal `before`'s bit for bit."""
    t_leaves = state_leaves(t_state)
    j_leaves = [np.asarray(x) for x in jax.tree.leaves(j_state)]
    assert len(t_leaves) == len(j_leaves)
    quant = is_quant(t_state.k_cache)
    for i, (t, j) in enumerate(zip(t_leaves, j_leaves)):
        t = t.numpy()
        if t.dtype == np.int8:  # int8 K/V codes
            assert np.abs(t.astype(int) - j.astype(int)).max() <= 1, i
        elif quant and i in (1, 3):  # their per-frame scales
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-7)
        elif t.dtype.kind == "f":
            np.testing.assert_allclose(t, j, atol=ATOL, err_msg=str(i))
        else:
            np.testing.assert_array_equal(t, j)
    if paused is not None:
        axes = [1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0] if quant else \
            [1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0]
        for t, b, ax in zip(t_leaves, before, axes):
            for r in np.nonzero(paused)[0]:
                assert torch.equal(t.select(ax, r), b.select(ax, r))


def snapshot(state):
    return [t.clone() for t in state_leaves(state)]


def check_bf16_states(t_state, j_state, paused, before):
    """bf16 under the port's bf16 rule (tests/test_torch_tick.py): the
    encoder's leaves (caches, validity) within 4 bf16 ulps of the JAX
    leaf's largest magnitude, the decode state not compared (its argmaxes
    may flip); paused rows equal `before`'s bit for bit."""
    t_leaves = state_leaves(t_state)
    j_leaves = [np.asarray(x) for x in jax.tree.leaves(j_state)]
    for i, (t, j) in enumerate(zip(t_leaves[:4], j_leaves[:4])):
        j = j.astype(np.float32)
        np.testing.assert_allclose(t.float().numpy(), j, rtol=0,
                                   atol=BF16_REL * np.abs(j).max(),
                                   err_msg=str(i))
    if paused is not None:
        axes = [1, 1, 1] + [0] * (len(t_leaves) - 3)
        for t, b, ax in zip(t_leaves, before, axes):
            for r in np.nonzero(paused)[0]:
                assert torch.equal(t.select(ax, r), b.select(ax, r))


@pytest.mark.parametrize("form", ["f32", "int8-kv", "bf16"])
def test_gated_stream_step_matches_jax(form):
    """f32 and int8 K/V: tokens equal, states within ATOL (codes within 1);
    bf16: the bf16 rule (at this size its tolerance does not tell an f32
    T=1 softmax in the window attention from a bf16 one)."""
    kv_int8, bf16 = form == "int8-kv", form == "bf16"
    jm, mp = jax_model(kv_int8, bf16)
    try:
        tm = TorchModel.random(
            tiny_hparams(), seed=1, device="cpu", kv_int8=kv_int8,
            dtype=torch.bfloat16 if bf16 else torch.float32)
        cfg_t, cfg_j = tm.cache_config(0), jm.cache_config(0)
        b, hp = 3, tm.hp
        rng = np.random.default_rng(7)
        j_state = jm.init_stream_state(b, cfg_j)
        t_state = tm.init_stream_state(b, cfg_t)
        nv = np.full(b, cfg_t.valid_out_len, np.int32)
        # (active mask, phase): all-active at 0, two gated steps at 1
        # (phase-stationary), all-active at 1 and the wrap, gated at 0
        steps = [(None, 0), ([1, 0, 1], 1), ([0, 1, 1], 1), (None, 1),
                 ([1, 1, 0], 0)]
        for active, phase in steps:
            mel = rng.standard_normal(
                (b, cfg_t.chunk_mel_frames, hp.n_mels)).astype(np.float32)
            act = None if active is None else np.asarray(active, bool)
            before = snapshot(t_state)
            j_state, j_tok = jm.stream_step(
                cfg_j, j_state, mel, nv, None if act is None else act,
                phase=phase)
            t_state, t_tok = tm.stream_step(
                cfg_t, t_state, torch.tensor(mel), torch.tensor(nv),
                None if act is None else torch.tensor(act), phase=phase)
            if not bf16:
                np.testing.assert_array_equal(t_tok.numpy(),
                                              np.asarray(j_tok))
            if act is None and phase == N_PHASES - 1:  # the wrap
                j_state = jm.compact_state(cfg_j, j_state)
                t_state = tm.compact_state(cfg_t, t_state)
            (check_bf16_states if bf16 else check_states)(
                t_state, j_state, None if act is None else ~act, before)
    finally:
        mp.undo()


def test_legacy_gated_fused_tick_matches_jax():
    """The engine's legacy flow by hand: all-active fused ticks advance the
    phase; before a gated tick the window compacts back to phase 0, and the
    gated tick stays there."""
    jm, mp = jax_model()
    try:
        tm = TorchModel.random(tiny_hparams(), seed=1, device="cpu")
        cfg_t, cfg_j = tm.cache_config(0), jm.cache_config(0)
        b, shift = 3, cfg_t.shift_samples
        audio = np.stack([make_audio(PRIME_SAMPLES + 6 * shift, s)
                          for s in range(b)])
        tails, lasts = zip(*(prime_carry(a[:PRIME_SAMPLES]) for a in audio))
        tails, lasts = np.stack(tails), np.asarray(lasts, np.float32)
        ones = np.ones(b, bool)
        j_state = jm.prime_frontend(jm.init_stream_state(b, cfg_j), ones,
                                    tails, lasts)
        t_state = tm.prime_frontend(tm.init_stream_state(b, cfg_t), ones,
                                    tails, lasts)
        off, phase = PRIME_SAMPLES, 0
        for active in (None, [1, 0, 1], [0, 1, 1], None, None, [1, 1, 0]):
            act = None if active is None else np.asarray(active, bool)
            if act is not None and phase:
                j_state = jm.compact_state(cfg_j, j_state, phase=phase)
                t_state = tm.compact_state(cfg_t, t_state, phase=phase)
                phase = 0
            packed = tm.pack_tick_inputs(
                audio[:, off:off + shift],
                np.full(b, cfg_t.valid_out_len, np.int16),
                np.zeros(b, np.int16), act)
            off += shift
            before = snapshot(t_state)
            j_state, j_tok = jm.fused_tick_packed(
                cfg_j, j_state, jm.put_batch(packed), act is None,
                phase=phase)
            t_state, t_tok = tm.fused_tick_packed(
                cfg_t, t_state, tm.put_batch(packed), act is None,
                phase=phase)
            np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
            check_states(t_state, j_state,
                         None if act is None else ~act, before)
            if act is None:
                phase += 1
                if phase == N_PHASES:
                    j_state = jm.compact_state(cfg_j, j_state)
                    t_state = tm.compact_state(cfg_t, t_state)
                    phase = 0
    finally:
        mp.undo()


AUDIOS = [make_audio(n, seed=20 + i) for i, n in enumerate((14000, 17000,
                                                              9000))]
# per round, the chunks each stream pushes (0: it starves, and pauses)
SCHEDULE = [(1, 0, 0), (1, 1, 0), (1, 0, 1), (0, 0, 1), (1, 1, 1),
            (2, 0, 1), (1, 3, 0), (0, 2, 2), (1, 1, 1), (3, 3, 3)]


def staggered(engine):
    """SCHEDULE with two ticks per round, then every stream ends; returns
    the events as (stream id, kind, text)."""
    pos, sids, events = [0, 0, 0], [None, None, None], []
    for rnd in SCHEDULE:
        for i, n in enumerate(rnd):
            if n and sids[i] is None:
                sids[i] = engine.start_stream(0)
            if sids[i] is not None:
                take = n * 1280 + (PRIME_SAMPLES if pos[i] == 0 and n else 0)
                engine.push_audio(sids[i], AUDIOS[i][pos[i]:pos[i] + take])
                pos[i] += take
        for _ in range(2):
            events.extend(engine.tick()[0])
    for i, sid in enumerate(sids):
        engine.push_audio(sid, AUDIOS[i][pos[i]:])
        engine.end_stream(sid)
    for _ in range(200):
        ev, more = engine.tick()
        events.extend(ev)
        if not more:
            return [(e.stream_id, e.kind, e.text) for e in events]
    raise AssertionError("engine did not go idle")


@pytest.mark.parametrize("flow", ["legacy", "phase-timers"])
def test_legacy_and_phase_timer_engines_match_jax(flow, monkeypatch):
    jm, mp = jax_model()
    try:
        if flow == "legacy":
            monkeypatch.setattr(jax_engine, "GATED_REALIGN", False)
        else:
            monkeypatch.setattr(jax_engine, "PHASE_TIMERS", True)
        want = staggered(jax_engine.BatchedEngine(jm, 3))
    finally:
        mp.undo()
    tm = TorchModel.random(tiny_hparams(), seed=1, device="cpu")
    engine = BatchedEngine(tm, 3, gated_realign=flow != "legacy",
                           phase_timers=flow == "phase-timers")
    engine.prewarm()  # the flow's variants; leaves a clean group
    got = staggered(engine)
    assert [k for _, k, _ in want].count("ended") == 3
    assert sum(bool(t) for _, _, t in want) >= 6
    assert got == want
    group = engine.groups[0]
    assert not group.use_realign
    stats = engine.stats()["groups"][0]
    if flow == "phase-timers":
        assert group.total_chunk_steps == group.total_steps  # k = 1 only
        assert stats["encoder_seconds"] > 0 and stats["decoder_seconds"] > 0
    else:
        assert "encoder_seconds" not in stats
    # the default flow gives the same transcripts
    assert staggered(BatchedEngine(tm, 3)) == got


@pytest.mark.parametrize("env, want", [({}, (True, False)), (
    {"NEMOTRON_TPU_GATED_REALIGN": "0", "NEMOTRON_TPU_PHASE_TIMERS": "1"},
    (False, True))])
def test_server_main_maps_the_flow_variables(tmp_path, monkeypatch, env,
                                             want):
    """The port's server maps the JAX engine's two variables onto the
    engine's gated_realign / phase_timers arguments."""
    from scripts_support import export_random_checkpoint

    from nemotron_tpu_torch.serving import server as server_mod

    path = str(tmp_path / "tiny.gguf")
    export_random_checkpoint(tiny_hparams(), path, seed=3)
    seen = {}

    async def serve(self, host=None, port=None, unix_path=None):
        seen["flow"] = (self.engine.gated_realign, self.engine.phase_timers)

    monkeypatch.setattr(server_mod.StreamServer, "serve", serve)
    for k in ("NEMOTRON_TPU_GATED_REALIGN", "NEMOTRON_TPU_PHASE_TIMERS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert server_mod.main([path, "--device", "cpu"]) == 0
    assert seen["flow"] == want


@pytest.mark.parametrize("depth, chunks", [(1, 1), (3, 2), (0, 0)],
                         ids=["depth1-k1", "depth3-k2", "clamped"])
def test_readback_depth_and_tick_chunks_match_jax(depth, chunks,
                                                  monkeypatch):
    """The JAX engine's READBACK_DEPTH / MAX_TICK_CHUNKS as the port's
    arguments, with the same max(1, ...) clamp: the same events."""
    jm, mp = jax_model()
    try:
        monkeypatch.setattr(jax_engine, "READBACK_DEPTH", max(1, depth))
        monkeypatch.setattr(jax_engine, "MAX_TICK_CHUNKS", max(1, chunks))
        want = staggered(jax_engine.BatchedEngine(jm, 3))
    finally:
        mp.undo()
    tm = TorchModel.random(tiny_hparams(), seed=1, device="cpu")
    engine = BatchedEngine(tm, 3, readback_depth=depth,
                           max_tick_chunks=chunks)
    got = staggered(engine)
    assert got == want
    group = engine.groups[0]
    assert group.readback_depth == max(1, depth)
    if max(1, chunks) == 1:  # no k-chunk tick ran
        assert group.total_chunk_steps == group.total_steps


@pytest.mark.parametrize("env, want", [
    ({}, (True, False, 2, 8)),
    ({"NEMOTRON_TPU_READBACK_DEPTH": "1",
      "NEMOTRON_TPU_MAX_TICK_CHUNKS": "1"}, (True, False, 1, 1)),
    ({"NEMOTRON_TPU_READBACK_DEPTH": "0", "NEMOTRON_TPU_MAX_TICK_CHUNKS": "4",
      "NEMOTRON_TPU_GATED_REALIGN": "0"}, (False, False, 1, 4))])
def test_server_main_maps_the_engine_variables(tmp_path, monkeypatch, env,
                                               want):
    """The port's server maps the JAX engine's four variables onto the
    engine's arguments (gated_realign, phase_timers, readback_depth,
    max_tick_chunks), and NEMOTRON_TPU_CONFIDENCE onto the model's."""
    from scripts_support import export_random_checkpoint

    from nemotron_tpu_torch.serving import server as server_mod

    path = str(tmp_path / "tiny.gguf")
    export_random_checkpoint(tiny_hparams(), path, seed=3)
    seen = {}

    async def serve(self, host=None, port=None, unix_path=None):
        e = self.engine
        seen["kw"] = (e.gated_realign, e.phase_timers, e.readback_depth,
                      e.max_tick_chunks)
        seen["confidence"] = e.model.confidence

    monkeypatch.setattr(server_mod.StreamServer, "serve", serve)
    for k in ("NEMOTRON_TPU_GATED_REALIGN", "NEMOTRON_TPU_PHASE_TIMERS",
              "NEMOTRON_TPU_READBACK_DEPTH", "NEMOTRON_TPU_MAX_TICK_CHUNKS",
              "NEMOTRON_TPU_CONFIDENCE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    confidence = "NEMOTRON_TPU_READBACK_DEPTH" in env
    if confidence:
        monkeypatch.setenv("NEMOTRON_TPU_CONFIDENCE", "1")
    assert server_mod.main([path, "--device", "cpu"]) == 0
    assert seen["kw"] == want
    assert seen["confidence"] == confidence
