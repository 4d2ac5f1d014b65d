"""The port's replica launcher and routed client (nemotron_tpu_torch/serving/
replicas.py, after tests/test_replicas.py): a RoutedClient over two of the
port's servers on the CPU balances four streams 2 / 2, each text equal to
a single-stream session's; ReplicaSet launches the port's server module
(SERVER_MODULE, with each replica's CUDA_VISIBLE_DEVICES), waits for the
listen lines and stops its processes, against stub processes; a silent
replica trips wait_ready's timeout; a stream handle keeps a full u32 stream
id. The two servers run in this process, as the JAX package's test runs
them (no model load in a subprocess)."""

import asyncio
import sys

import numpy as np
import pytest
import torch

from helpers import tiny_hparams

from nemotron_tpu_torch.api import ASRModel
from nemotron_tpu_torch.serving import replicas as R
from nemotron_tpu_torch.serving.replicas import (SERVER_MODULE, ReplicaSet,
                                                 RoutedClient)
from nemotron_tpu_torch.serving.server import StreamServer
from nemotron_tpu_torch.streaming.session import StreamSession

torch.set_num_threads(1)


def make_audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = 0.4 * np.sin(2 * np.pi * 260 * t) + 0.2 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


def test_routed_client_balances_and_matches_sessions():
    model = ASRModel.random(tiny_hparams(), seed=1, device="cpu")
    audios = {i: make_audio(8000, seed=10 + i) for i in range(4)}
    want = {}
    for i, audio in audios.items():
        s = StreamSession(model, 0)
        s.process_incremental(audio)
        s.finalize()
        want[i] = s.get_transcript()
    assert any(want.values())

    async def run():
        srvs, servers, addrs = [], [], []
        for _ in range(2):  # two replicas sharing one model (a CPU test)
            srv = StreamServer(model, batch_per_group=4)
            server = await srv.start("127.0.0.1", 0)
            srvs.append(srv)
            servers.append(server)
            addrs.append(("127.0.0.1", server.sockets[0].getsockname()[1]))
        try:
            rc = await RoutedClient.connect(addrs)
            handles = {i: await rc.start_stream(0) for i in audios}
            assert rc.live == [2, 2], rc.live  # least-loaded: 2 / 2
            assert {h >> RoutedClient._REP_SHIFT
                    for h in handles.values()} == {0, 1}
            got = await asyncio.gather(*(
                rc.transcribe(handles[i], audios[i], chunk_ms=100)
                for i in audios))
            rc.close()
            assert rc.live == [0, 0]
            return dict(zip(audios, got))
        finally:
            for srv, server in zip(srvs, servers):
                await srv.stop(server)

    assert asyncio.run(asyncio.wait_for(run(), timeout=120)) == want


def stub_popen(monkeypatch, script, seen):
    real = R.subprocess.Popen

    def popen(cmd, **kw):
        seen.append((cmd, kw.get("env", {})))
        return real([sys.executable, str(script)], **kw)

    monkeypatch.setattr(R.subprocess, "Popen", popen)


def test_replica_set_lifecycle_launches_the_ports_server(tmp_path,
                                                        monkeypatch):
    stub = tmp_path / "stub_server.py"
    stub.write_text("import sys, time\n"
                    "print('listening on stub', file=sys.stderr, flush=True)\n"
                    "time.sleep(300)\n")
    seen = []
    stub_popen(monkeypatch, stub, seen)
    rs = ReplicaSet("m.gguf", n_replicas=2, port_base=18210,
                    extra_args=["--device", "cuda"],
                    env_per_replica=[{"CUDA_VISIBLE_DEVICES": "0"},
                                     {"CUDA_VISIBLE_DEVICES": "1"}])
    try:
        rs.wait_ready(timeout=60)
        assert rs.addrs == [("127.0.0.1", 18210), ("127.0.0.1", 18211)]
        assert all(p.poll() is None for p in rs.procs)
    finally:
        rs.close()
    assert all(p.poll() is not None for p in rs.procs)
    assert SERVER_MODULE == "nemotron_tpu_torch.serving.server"
    for i, (cmd, env) in enumerate(seen):
        assert cmd[1:5] == ["-m", SERVER_MODULE, "m.gguf", "--host"]
        assert cmd[-2:] == ["--device", "cuda"]
        assert str(18210 + i) in cmd
        assert env["CUDA_VISIBLE_DEVICES"] == str(i)


def test_routed_handle_packs_full_u32_sid():
    rc = RoutedClient.__new__(RoutedClient)
    big_sid = (1 << 24) + 7
    assert rc._route((3 << RoutedClient._REP_SHIFT) | big_sid) == (3, big_sid)
    assert rc._route(big_sid) == (0, big_sid)
    assert rc._route((1 << 32) - 1) == (0, (1 << 32) - 1)


def test_wait_ready_times_out_on_silent_replica(tmp_path, monkeypatch):
    stub = tmp_path / "silent.py"
    stub.write_text("import time\ntime.sleep(300)\n")
    stub_popen(monkeypatch, stub, [])
    rs = ReplicaSet("m.gguf", n_replicas=1, port_base=18310)
    try:
        with pytest.raises(TimeoutError):
            rs.wait_ready(timeout=1.5)
    finally:
        rs.close()
