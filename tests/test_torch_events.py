"""Engine events with their decode position and confidence (after
tests/test_confidence.py:73): on the same random tiny weights
(tests/helpers.tiny_hparams, seed 1), with per-token confidences packed
(the port's confidence=True, the JAX package's NEMOTRON_TPU_CONFIDENCE=1),
the port's BatchedEngine and the JAX one emit the same events under one
schedule (a late join, a pause, k-chunk backlog ticks, a finalize off a
chunk boundary): equal stream, kind, text and at_sec (exact), conf within
1e-5. at_sec never decreases within a stream and conf lies in (0, 1]; the
tokens equal those of a confidence=False engine, whose events carry
conf -1. Both packages run right context 0 with N_PHASES phases (the JAX
package compiles a tick per phase)."""

import numpy as np
import pytest
import torch

from helpers import tiny_hparams

from nemotron_tpu.api import ASRModel as JaxModel
from nemotron_tpu.config import CacheConfig as JaxCacheConfig
from nemotron_tpu.streaming.engine import BatchedEngine as JaxEngine
from nemotron_tpu_torch.api import ASRModel as TorchModel
from nemotron_tpu_torch.config import CacheConfig
from nemotron_tpu_torch.streaming.engine import BatchedEngine

torch.set_num_threads(1)

N_PHASES = 2


@pytest.fixture(autouse=True)
def few_phases(monkeypatch):
    for cls in (JaxCacheConfig, CacheConfig):
        monkeypatch.setitem(cls._MODE_N_PHASES, 0, N_PHASES)


def make_audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = 0.5 * np.sin(2 * np.pi * (230 + 40 * seed) * t) \
        + 0.2 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


# long enough for decode positions past frame 35, the first whose at_sec
# depends on the order of the product (frame x 8 x 160 / 16000)
AUDIOS = [make_audio(60000, 1), make_audio(30000, 2)]
# per tick, the samples each stream pushes (None: not started yet)
SCHEDULE = [(1600, None), (1600, None), (1600, 3000), (0, 3000),
            (0, 0), (6400, 3000)]


def drive(engine):
    """SCHEDULE, then every stream ends and the engine runs idle; returns
    the events."""
    sids, pos, events = [None, None], [0, 0], []
    for step in SCHEDULE:
        for i, n in enumerate(step):
            if n is None:
                continue
            if sids[i] is None:
                sids[i] = engine.start_stream(0)
            engine.push_audio(sids[i], AUDIOS[i][pos[i]:pos[i] + n])
            pos[i] += n
        events.extend(engine.tick()[0])
    for i, sid in enumerate(sids):
        engine.push_audio(sid, AUDIOS[i][pos[i]:])
        engine.end_stream(sid)
    for _ in range(200):
        ev, more = engine.tick()
        events.extend(ev)
        if not more:
            return events
    raise AssertionError("engine did not go idle")


@pytest.fixture(scope="module")
def jax_events():
    mp = pytest.MonkeyPatch()
    mp.setenv("NEMOTRON_TPU_CONFIDENCE", "1")
    mp.setitem(JaxCacheConfig._MODE_N_PHASES, 0, N_PHASES)
    try:
        return drive(JaxEngine(JaxModel.random(tiny_hparams(), seed=1), 2))
    finally:
        mp.undo()


def test_events_match_jax_with_position_and_confidence(jax_events):
    model = TorchModel.random(tiny_hparams(), seed=1, device="cpu",
                              confidence=True)
    got = drive(BatchedEngine(model, 2))
    assert [e.kind for e in jax_events].count("ended") == 2
    assert sum(bool(e.text) for e in jax_events) >= 4
    key = [(e.stream_id, e.kind, e.text, e.at_sec) for e in got]
    assert key == [(e.stream_id, e.kind, e.text, e.at_sec)
                   for e in jax_events]
    np.testing.assert_allclose([e.conf for e in got],
                               [e.conf for e in jax_events], atol=1e-5)
    last = {}
    for e in got:
        if e.text:
            assert 0.0 < e.conf <= 1.0
            assert e.at_sec >= last.get(e.stream_id, 0.0)
            last[e.stream_id] = e.at_sec


def test_confidence_engine_tokens_equal_the_plain_engine():
    engines = {}
    for conf in (False, True):
        model = TorchModel.random(tiny_hparams(), seed=1, device="cpu",
                                  confidence=conf)
        engines[conf] = BatchedEngine(model, 2)
        events = drive(engines[conf])
        if not conf:
            plain = events
    assert [(e.stream_id, e.kind, e.text, e.at_sec) for e in events] == \
        [(e.stream_id, e.kind, e.text, e.at_sec) for e in plain]
    assert all(e.conf == -1.0 for e in plain)
    assert any(e.conf > 0 for e in events)
