"""Right contexts past 0 through the port's BatchedEngine and StreamServer
against the JAX package's, on the CPU with the same random tiny weights in
both packages (tests/helpers.tiny_hparams, seed 1):

  - one engine holding a group at right context 0 and a group at 13, the
    streams ticked by hand in the same schedule in both packages (k-chunk
    backlog ticks, masked ticks, finalize on and off chunk boundaries):
    the event sequences (stream, kind, text) are equal;
  - a client that STARTs with right_context 1, 6 or 13 gets from the
    port's server the transcript the JAX server gives it.

The JAX package compiles one tick per phase, k and mask, so both packages
run right contexts 0, 1 and 6 with N_PHASES slack-buffer phases in place
of their defaults (13 has 2 already); tests/test_torch_right_context.py
holds the tick at each mode's own n_phases."""

import asyncio

import numpy as np
import pytest
import torch

from helpers import tiny_hparams

from nemotron_tpu.api import ASRModel as JaxModel
from nemotron_tpu.config import CacheConfig as JaxCacheConfig
from nemotron_tpu.serving.client import transcribe_file
from nemotron_tpu.serving.server import StreamServer as JaxServer
from nemotron_tpu.streaming.engine import BatchedEngine as JaxEngine
from nemotron_tpu_torch.api import ASRModel as TorchModel
from nemotron_tpu_torch.config import CacheConfig
from nemotron_tpu_torch.serving.server import StreamServer
from nemotron_tpu_torch.streaming.engine import BatchedEngine

torch.set_num_threads(1)

N_PHASES = 2


@pytest.fixture(autouse=True)
def few_phases(monkeypatch):
    for cls in (JaxCacheConfig, CacheConfig):
        for mode in (0, 1, 6):
            monkeypatch.setitem(cls._MODE_N_PHASES, mode, N_PHASES)


def models():
    hp = tiny_hparams()
    return (JaxModel.random(hp, seed=1),
            TorchModel.random(hp, seed=1, device="cpu"))


def make_audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = 0.4 * np.sin(2 * np.pi * (220 + 30 * seed) * t) \
        + 0.2 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


def drive(engine, streams):
    """Start `streams` [(right_context, audio)] on `engine`, push all their
    audio (the groups take k-chunk backlog ticks), tick twice, end every
    stream and tick until idle. Returns the events as (stream id, kind,
    text)."""
    sids = [engine.start_stream(rc) for rc, _ in streams]
    for sid, (_, a) in zip(sids, streams):
        engine.push_audio(sid, a)
    events = engine.tick()[0] + engine.tick()[0]
    for sid in sids:
        engine.end_stream(sid)
    for _ in range(200):
        ev, more = engine.tick()
        events.extend(ev)
        if not more:
            break
    else:
        raise AssertionError("engine did not go idle")
    return [(e.stream_id, e.kind, e.text) for e in events]


def test_engine_with_r0_and_r13_groups_matches_jax():
    jm, tm = models()
    shift13 = CacheConfig.for_mode(13).shift_samples
    streams = [(0, make_audio(9000, 1)),
               (13, make_audio(3 * shift13 + 96, 2)),  # on a chunk boundary
               (13, make_audio(2 * shift13 + 5000, 3)),
               (0, make_audio(6500, 4))]
    want = drive(JaxEngine(jm, batch_per_group=2), streams)
    engine = BatchedEngine(tm, batch_per_group=2)
    got = drive(engine, streams)
    assert got == want
    assert sorted(engine.groups) == [0, 13]
    ended = {sid for sid, kind, _ in got if kind == "ended"}
    assert ended == {1, 2, 3, 4}
    texts = {sid: "" for sid in ended}
    for sid, _, text in got:
        texts[sid] += text
    assert all(texts.values()), texts
    group = engine.groups[13]
    assert group.total_chunk_steps > group.total_steps  # a k=2 tick ran


async def _jax_transcript(model, audio, rc):
    srv = JaxServer(model, batch_per_group=1)
    srv._engine_task = asyncio.create_task(srv.engine_loop())
    server = await asyncio.start_server(srv.handle_conn, "127.0.0.1", 0)
    try:
        return await asyncio.wait_for(transcribe_file(
            audio, host="127.0.0.1", port=server.sockets[0].getsockname()[1],
            right_context=rc, chunk_ms=100), timeout=120)
    finally:
        srv._stop = True
        server.close()
        srv._engine_task.cancel()


async def _torch_transcript(model, audio, rc):
    srv = StreamServer(model, batch_per_group=1)
    server = await srv.start("127.0.0.1", 0)
    try:
        return await asyncio.wait_for(transcribe_file(
            audio, host="127.0.0.1", port=server.sockets[0].getsockname()[1],
            right_context=rc, chunk_ms=100), timeout=120)
    finally:
        await srv.stop(server)


@pytest.mark.parametrize("rc", [1, 6, 13])
def test_server_transcribes_right_context_as_jax(rc):
    jm, tm = models()
    cfg = CacheConfig.for_mode(rc)
    audio = make_audio(96 + 2 * cfg.shift_samples + 3000, seed=rc)
    want = asyncio.run(_jax_transcript(jm, audio, rc))
    got = asyncio.run(_torch_transcript(tm, audio, rc))
    assert got == want and len(want) > 10
