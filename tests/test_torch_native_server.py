"""The port's native ingest server (serving/native_server.py on the C++ epoll
thread of csrc/host/ingest_server.cpp) on the CPU, after
tests/test_native_server.py: through real TCP sockets, a stream's text
equals the port's StreamSession and the JAX package's native server on the
same random tiny weights (tests/helpers.tiny_hparams, seed 1); two streams
on one connection; a bad opcode's OP_ERROR, an ACK and an abrupt
disconnect; budget backpressure; a model on a dp mesh (the text of a
single-device session); the refusals of live-stream migration and
hot swap on a native-ingest engine; and a library that does not build
raising the compiler's message instead of falling back.

The C++ layer is a process-wide singleton per library (the port's and the
JAX package's are two libraries), so each test runs its own server start /
stop cycle. Both packages run right context 0 with N_PHASES slack-buffer
phases (the JAX package compiles a tick per phase)."""

import asyncio
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from helpers import tiny_hparams

from nemotron_tpu.api import ASRModel as JaxModel
from nemotron_tpu.config import CacheConfig as JaxCacheConfig
from nemotron_tpu.serving.client import transcribe_file
from nemotron_tpu_torch.api import ASRModel as TorchModel
from nemotron_tpu_torch.config import CacheConfig
from nemotron_tpu_torch.serving import ingest
from nemotron_tpu_torch.serving import protocol as P
from nemotron_tpu_torch.serving.native_server import NativeStreamServer
from nemotron_tpu_torch.serving.server import StreamServer
from nemotron_tpu_torch.streaming.engine import BatchedEngine
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
    sig = 0.4 * np.sin(2 * np.pi * 260 * t) + 0.2 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


@pytest.fixture(scope="module")
def model():
    return TorchModel.random(tiny_hparams(), seed=1, device="cpu")


def session_text(model, audio):
    s = StreamSession(model, 0)
    s.process_incremental(audio)
    s.finalize()
    return s.get_transcript()


class running_server:
    """A native server (the port's, or the JAX package's given its class)
    serving on a background thread."""

    def __init__(self, model, batch=4, mem_budget=P.DEFAULT_MEM_BUDGET,
                 cls=NativeStreamServer):
        self.srv = cls(model, batch_per_group=batch, mem_budget=mem_budget)

    def __enter__(self):
        self.port = self.srv.start("127.0.0.1", 0)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.srv.stop()
        self.thread.join(timeout=30)
        return False


HDR = struct.Struct("<BII")


class RawClient:
    """A blocking-socket protocol client for frame-level assertions."""

    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=30)

    def send(self, op, sid, payload=b""):
        if isinstance(payload, str):
            payload = payload.encode()
        self.sock.sendall(HDR.pack(op, sid, len(payload)) + payload)

    def recv(self):
        hdr = b""
        while len(hdr) < HDR.size:
            got = self.sock.recv(HDR.size - len(hdr))
            if not got:
                raise ConnectionError("closed")
            hdr += got
        op, sid, ln = HDR.unpack(hdr)
        payload = b""
        while len(payload) < ln:
            payload += self.sock.recv(ln - len(payload))
        return op, sid, payload

    def close(self):
        self.sock.close()


def serve_file(rs, audio, chunk_ms=100):
    return asyncio.run(asyncio.wait_for(
        transcribe_file(audio, host="127.0.0.1", port=rs.port,
                        chunk_ms=chunk_ms), timeout=120))


def test_native_server_matches_session_and_jax_native_server(model):
    from nemotron_tpu.serving.native_server import (
        NativeStreamServer as JaxNativeServer)

    audio = make_audio(9600, seed=1)
    want = session_text(model, audio)
    assert len(want) > 5
    with running_server(model) as rs:
        got = serve_file(rs, audio)
        assert rs.srv.engine.groups[0].source is rs.srv.ingest
    assert got == want
    jm = JaxModel.random(tiny_hparams(), seed=1)
    with running_server(jm, cls=JaxNativeServer) as rs:
        jax_text = serve_file(rs, audio)
    assert jax_text == got


def test_native_server_on_dp_mesh_matches_session(model):
    """The native ingest path with a model on a dp = 4 mesh of ["cpu"] * 4
    (--native --dp, after tests/test_native_server.py:335): two streams'
    texts equal the single-device session's."""
    from nemotron_tpu_torch.parallel.mesh import make_mesh

    sharded = TorchModel.random(tiny_hparams(), seed=1, device="cpu").shard(
        make_mesh(4, 1, devices=["cpu"] * 4))
    audios = [make_audio(9600, seed=3), make_audio(6400, seed=4)]
    want = [session_text(model, a) for a in audios]
    assert all(want)
    with running_server(sharded, batch=4) as rs:
        got = [serve_file(rs, a) for a in audios]
        assert rs.srv.engine.groups[0].state.shards[3] is not None
    assert got == want


def test_native_server_two_streams_one_connection(model):
    a0, a1 = make_audio(8000, seed=2), make_audio(8000, seed=3)
    want = {0: session_text(model, a0), 1: session_text(model, a1)}
    with running_server(model) as rs:
        c = RawClient(rs.port)
        c.send(P.OP_STREAM_START, 0, b"{}")
        op, _, pl = c.recv()
        assert op == P.OP_STARTED
        sid0 = json.loads(pl)["id"]
        c.send(P.OP_STREAM_START, 0, b"{}")
        texts, ended, pushed1 = {0: "", 1: ""}, set(), False
        for off in range(0, 8000, 1600):
            c.send(P.OP_PUSH, sid0, a0[off:off + 1600].tobytes())
        c.send(P.OP_STREAM_END, sid0)
        deadline = time.time() + 120
        while len(ended) < 2 and time.time() < deadline:
            op, sid, pl = c.recv()
            if op == P.OP_STARTED:  # may arrive among the ACKs
                sid1 = json.loads(pl)["id"]
                for off in range(0, 8000, 1600):
                    c.send(P.OP_PUSH, sid1, a1[off:off + 1600].tobytes())
                c.send(P.OP_STREAM_END, sid1)
                pushed1 = True
            elif op in (P.OP_TEXT, P.OP_ENDED):
                texts[0 if sid == sid0 else 1] += pl.decode()
                if op == P.OP_ENDED:
                    ended.add(sid)
        c.close()
    assert pushed1 and len(ended) == 2
    assert texts == want


def test_native_server_ack_error_and_abrupt_disconnect(model):
    with running_server(model, batch=2) as rs:
        c = RawClient(rs.port)
        c.send(0x77, 5, b"")  # bad opcode: OP_ERROR from the C++ layer
        op, _, pl = c.recv()
        assert op == P.OP_ERROR and b"bad opcode" in pl
        c.send(P.OP_STREAM_START, 0, b'{"right_context": 5}')
        op, _, pl = c.recv()
        assert op == P.OP_ERROR and b"must be one of" in pl
        c.send(P.OP_STREAM_START, 0, b"{}")
        op, _, pl = c.recv()
        assert op == P.OP_STARTED
        sid = json.loads(pl)["id"]
        c.send(P.OP_PUSH, sid, make_audio(1600, seed=4).tobytes())
        op, rsid, pl = c.recv()
        assert op == P.OP_ACK and rsid == sid
        assert json.loads(pl)["queued_samples"] <= 1600
        c.send(P.OP_PUSH, 9999, b"\x00\x00" * 100)  # not this conn's: ignored
        c.close()  # abrupt disconnect mid-stream: the slot is reclaimed
        deadline = time.time() + 30
        groups = rs.srv.engine.groups
        while time.time() < deadline and not (
                groups and all(g.n_active_streams == 0
                               for g in groups.values())):
            time.sleep(0.05)
        assert groups and all(g.n_active_streams == 0
                              for g in groups.values())
        c2 = RawClient(rs.port)  # and serving goes on
        c2.send(P.OP_STREAM_START, 0, b"{}")
        assert c2.recv()[0] == P.OP_STARTED
        c2.close()


def test_native_server_budget_backpressure(model):
    """A budget of 4000 samples' bytes against 12800 pushed: the C++ layer
    parks the reader, the engine's takes release budget, and the text is
    the session's."""
    audio = make_audio(12800, seed=5)
    with running_server(model, mem_budget=8000) as rs:
        got = serve_file(rs, audio)
    assert got == session_text(model, audio)


class _Source:
    """A stand-in native source that stages nothing."""

    def status(self, sids):
        n = len(sids)
        return np.zeros(n, np.int64), np.zeros(n, np.uint64)

    def take_block(self, sids, take_n, out):
        return 0


def test_native_engines_refuse_migration_and_hot_swap(model):
    engine = BatchedEngine(model, 2, source=_Source())
    sid = engine.start_stream()
    fut = engine.request_export(sid)
    imp = engine.request_import({"right_context": 0})
    engine.tick()
    for f in (fut, imp):
        with pytest.raises(NotImplementedError, match="native-ingest"):
            f.result(timeout=5)

    async def swap():
        srv = StreamServer(model, batch_per_group=2)
        srv.engine = engine
        await srv.hot_swap(model)

    with pytest.raises(NotImplementedError, match="native-ingest"):
        asyncio.run(swap())


def test_failed_ingest_build_raises_the_compilers_message(model, tmp_path,
                                                         monkeypatch):
    bad = tmp_path / "ingest_server.cpp"
    bad.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(ingest, "_SRC", str(bad))
    monkeypatch.setattr(ingest, "_SO", str(tmp_path / "_build" / "x.so"))
    monkeypatch.setattr(ingest, "_lib", None)
    srv = NativeStreamServer(model, batch_per_group=2)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        srv.start("127.0.0.1", 0)
    assert "error" in str(e.value) and srv.engine is None
    # a fresh load after the failure raises the same way, never a fallback
    with pytest.raises(RuntimeError, match="unavailable"):
        ingest.require_native_ingest()
