"""Diarization over the serving protocol in the port's server, after
tests/test_server_diarize.py, on the CPU: a stream that STARTs with
{"diarize": true} on a server given a diarize model gets OP_DIARIZE word
JSONL frames as words decode and one final {"type": "result", ...} frame
ahead of its OP_ENDED, the frames equal to the JAX server's on the same
random tiny ASR weights (tests/helpers.tiny_hparams, seed 1), the same
random diarize checkpoint (seed 7) and the same pushes; plain and diarize
streams multiplex on one engine; a slow NME-SC finalize stalls no other
stream; diarization on a server without a model is a protocol error.

Both servers run one chunk per tick (the JAX engine's MAX_TICK_CHUNKS = 1,
the port's max_tick_chunks=1), so that the text events, and with them the
words' decode positions, do not depend on how far a client runs ahead, and
right context 0 with N_PHASES slack-buffer phases."""

import asyncio
import json
import time

import numpy as np
import pytest
import torch

from helpers import tiny_hparams
from scripts_support import export_random_diarize_checkpoint

from nemotron_tpu.api import ASRModel as JaxModel
from nemotron_tpu.config import CacheConfig as JaxCacheConfig
from nemotron_tpu.diarize.params import load_diarize_model as jload
from nemotron_tpu.serving.client import StreamClient, transcribe_file
from nemotron_tpu.serving.server import StreamServer as JaxServer
from nemotron_tpu.streaming import engine as jax_engine
from nemotron_tpu_torch.api import ASRModel as TorchModel
from nemotron_tpu_torch.config import CacheConfig
from nemotron_tpu_torch.diarize.params import load_diarize_model
from nemotron_tpu_torch.diarize.pipeline import DiarizePipeline
from nemotron_tpu_torch.serving import protocol as P
from nemotron_tpu_torch.serving.server import StreamServer
from nemotron_tpu_torch.streaming.session import StreamSession

torch.set_num_threads(1)

N_PHASES = 2


@pytest.fixture(autouse=True)
def few_phases(monkeypatch):
    for cls in (JaxCacheConfig, CacheConfig):
        monkeypatch.setitem(cls._MODE_N_PHASES, 0, N_PHASES)


def make_audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = 0.5 * np.sin(2 * np.pi * 260 * t) + 0.2 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


@pytest.fixture(scope="module")
def diarize_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dz") / "diarize.gguf")
    export_random_diarize_checkpoint(path, seed=7)
    return path


@pytest.fixture(scope="module")
def model():
    return TorchModel.random(tiny_hparams(), seed=1, device="cpu")


async def _serve(srv):
    server = await asyncio.start_server(srv.handle_conn, "127.0.0.1", 0)
    srv._engine_task = asyncio.create_task(srv.engine_loop())
    return server, server.sockets[0].getsockname()[1]


def diarized_run(srv, audio):
    """One diarize stream of `audio` (pushed 100 ms at a time) through
    `srv`; returns (transcript, the OP_DIARIZE lines)."""
    async def run():
        server, port = await _serve(srv)
        lines: list[str] = []
        try:
            text = await asyncio.wait_for(
                transcribe_file(audio, host="127.0.0.1", port=port,
                                chunk_ms=100, diarize=True,
                                on_diarize=lines.append), timeout=120)
            return text, lines
        finally:
            server.close()
            srv._engine_task.cancel()

    return asyncio.run(run())


def test_diarize_frames_equal_the_jax_servers(model, diarize_path,
                                              monkeypatch):
    audio = make_audio(2 * 16000, seed=2)
    sess = StreamSession(model, 0)
    sess.process_incremental(audio)
    sess.finalize()

    got_text, got = diarized_run(
        StreamServer(model, batch_per_group=4, max_tick_chunks=1,
                     diarize_params=load_diarize_model(diarize_path,
                                                       device="cpu")),
        audio)
    monkeypatch.setattr(jax_engine, "MAX_TICK_CHUNKS", 1)
    want_text, want = diarized_run(
        JaxServer(JaxModel.random(tiny_hparams(), seed=1),
                  batch_per_group=4, diarize_params=jload(diarize_path)),
        audio)
    assert got_text == want_text == sess.get_transcript()
    assert got == want
    objs = [json.loads(x) for x in got]
    words = [o for o in objs if "word" in o]
    assert len(words) == len(got_text.split()) > 0
    assert [o for o in objs if o.get("type") == "result"] == [objs[-1]]
    assert objs[-1]["n_speakers"] >= 1 and objs[-1]["rttm"]
    ats = [w["at"] for w in words]
    assert ats == sorted(ats) and ats[0] < 1.0 and ats[-1] <= 2.5


def test_plain_and_diarize_streams_multiplex(model, diarize_path):
    a_plain = make_audio(9600, seed=3)
    a_diar = make_audio(16000, seed=4)
    srv = StreamServer(model, batch_per_group=4,
                       diarize_params=load_diarize_model(diarize_path,
                                                         device="cpu"))

    async def run():
        server, port = await _serve(srv)
        try:
            client = await StreamClient.connect("127.0.0.1", port)
            sid_p = await client.start_stream()
            sid_d = await client.start_stream(diarize=True)
            for off in range(0, 16000, 1600):
                await client.push(sid_p, a_plain[off:off + 1600])
                await client.push(sid_d, a_diar[off:off + 1600])
            await client.send(P.OP_STREAM_END, sid_p)
            await client.send(P.OP_STREAM_END, sid_d)
            ended, frames, texts = set(), [], {sid_p: "", sid_d: ""}
            while len(ended) < 2:
                op, rsid, payload = await asyncio.wait_for(client.recv(),
                                                           timeout=60)
                if op in (P.OP_TEXT, P.OP_ENDED):
                    texts[rsid] += payload.decode("utf-8", "replace")
                    if op == P.OP_ENDED:
                        ended.add(rsid)
                elif op == P.OP_DIARIZE:
                    frames.append((rsid, payload.decode()))
            client.close()
            return texts, frames, sid_p, sid_d
        finally:
            server.close()
            srv._engine_task.cancel()

    texts, frames, sid_p, sid_d = asyncio.run(run())
    for sid, a in ((sid_p, a_plain), (sid_d, a_diar)):
        s = StreamSession(model, 0)
        s.process_incremental(a)
        s.finalize()
        assert texts[sid] == s.get_transcript() and texts[sid]
    assert frames and {sid for sid, _ in frames} == {sid_d}
    assert json.loads(frames[-1][1])["type"] == "result"
    # the double-billed staging copy and the queued PCM are all released
    assert srv.mem_used == 0 and not srv._diar_staged


def test_slow_finalize_does_not_stall_other_streams(model, diarize_path,
                                                    monkeypatch):
    """NME-SC runs on the worker thread: while a diarize stream's slow
    clustering runs, a paced plain stream keeps getting ticked, and the
    result frame still precedes the diarize stream's OP_ENDED."""
    sleep = 1.5
    marks = {"start": None}
    orig = DiarizePipeline.finalize_cluster

    def slow(self):
        marks["start"] = time.monotonic()
        time.sleep(sleep)
        return orig(self)

    monkeypatch.setattr(DiarizePipeline, "finalize_cluster", slow)
    srv = StreamServer(model, batch_per_group=4,
                       diarize_params=load_diarize_model(diarize_path,
                                                         device="cpu"))
    a_diar, a_live = make_audio(16000, seed=5), make_audio(16000, seed=6)

    async def run():
        server, port = await _serve(srv)
        try:
            client = await StreamClient.connect("127.0.0.1", port)
            sid_d = await client.start_stream(diarize=True)
            sid_l = await client.start_stream()
            await client.push(sid_d, a_diar)
            arrivals = {"result": None, "ended_d": None}
            samples: list[tuple[float, int]] = []

            async def sampler():
                while arrivals["ended_d"] is None:
                    g = srv.engine.groups.get(0)
                    samples.append((time.monotonic(),
                                    g.total_steps if g else 0))
                    await asyncio.sleep(0.03)

            async def pusher():
                off = 0
                deadline = time.monotonic() + 60
                while (arrivals["result"] is None
                       and time.monotonic() < deadline):
                    await client.push(sid_l, a_live[off:off + 1600])
                    off = (off + 1600) % len(a_live)
                    await asyncio.sleep(0.05)
                await client.send(P.OP_STREAM_END, sid_l)

            async def receiver():
                ended = set()
                while len(ended) < 2:
                    op, rsid, payload = await asyncio.wait_for(
                        client.recv(), timeout=60)
                    now = time.monotonic()
                    if op == P.OP_DIARIZE:
                        if json.loads(payload).get("type") == "result":
                            arrivals["result"] = now
                    elif op == P.OP_ENDED:
                        ended.add(rsid)
                        if rsid == sid_d:
                            arrivals["ended_d"] = now

            task = asyncio.ensure_future(sampler())
            await client.send(P.OP_STREAM_END, sid_d)
            await asyncio.gather(pusher(), receiver())
            task.cancel()
            client.close()
            return arrivals, samples
        finally:
            server.close()
            srv._engine_task.cancel()

    arrivals, samples = asyncio.run(run())
    assert arrivals["result"] is not None
    assert arrivals["result"] <= arrivals["ended_d"]
    t0 = marks["start"]
    window = [s for t, s in samples if t0 + 0.2 <= t <= t0 + sleep - 0.1]
    assert len(window) >= 10
    assert max(window) - min(window) >= 2  # ticks went on meanwhile


def test_diarize_without_server_model_is_an_error(model):
    srv = StreamServer(model, batch_per_group=2)

    async def run():
        server, port = await _serve(srv)
        try:
            client = await StreamClient.connect("127.0.0.1", port)
            with pytest.raises(RuntimeError, match="diarization not enabled"):
                await client.start_stream(diarize=True)
            assert await client.start_stream() >= 1  # the connection lives
            client.close()
        finally:
            server.close()
            srv._engine_task.cancel()

    asyncio.run(run())
