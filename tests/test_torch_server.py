"""The port's server on the CPU: two TCP clients, each transcript equal to the
port's direct tick loop over the same audio (tokens are exact, not within a
tolerance), plus the refusals the port makes at START (a right context
outside 0, 1, 6, 13; diarization on a server without a diarize model) and
in main (--diarize with --native, a batch that --dp does not divide);
main's --device cpu --dp 2 --tp 2 serves a mesh of ["cpu"] * 4, each text
equal to a single-device session's. Right contexts 1, 6
and 13 against the JAX server: tests/test_torch_right_context_serving.py;
diarization: tests/test_torch_server_diarize.py; the native ingest server:
tests/test_torch_native_server.py."""

import asyncio
import json

import numpy as np
import pytest
import torch

from helpers import tiny_hparams

from nemotron_tpu.serving import protocol as P
from nemotron_tpu.serving.client import StreamClient, transcribe_file
from nemotron_tpu_torch.api import ASRModel
from nemotron_tpu_torch.serving.server import (StreamServer,
                                               load_model_from_args, main,
                                               parse_args)
from nemotron_tpu_torch.streaming.session import StreamSession
from nemotron_tpu_torch.streaming.engine import PRIME_SAMPLES, prime_carry

torch.set_num_threads(1)


def make_audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = 0.4 * np.sin(2 * np.pi * 260 * t) + 0.2 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


def build_model():
    # seed 1: this random tiny model emits a varied token stream
    return ASRModel.random(tiny_hparams(), seed=1, device="cpu")


def direct_transcript(model, audio, batch=4):
    """One stream in slot 0 of a `batch`-slot state, driven tick by tick
    through ASRModel.fused_tick_packed as the engine drives it."""
    cfg = model.cache_config(0)
    shift, b = cfg.shift_samples, batch
    state = model.init_stream_state(b, cfg)
    mask = np.zeros(b, bool)
    mask[0] = True
    tails = np.zeros((b, 352), np.float32)
    lasts = np.zeros(b, np.float32)
    tails[0], lasts[0] = prime_carry(audio[:PRIME_SAMPLES])
    state = model.prime_frontend(state, mask, tails, lasts)
    rest = audio[PRIME_SAMPLES:]
    ids, phase, steps = [], 0, 0

    def tick(block, nv):
        nonlocal state, phase
        blk = np.zeros((b, shift), np.int16)
        blk[0, :len(block)] = block
        n_valid = np.zeros(b, np.int16)
        n_valid[0] = nv
        packed = model.pack_tick_inputs(blk, n_valid, np.zeros(b, np.int16),
                                        mask)
        state, toks = model.fused_tick_packed(
            cfg, state, model.put_batch(packed), False, phase=phase,
            fast_gated=True)
        ids.extend(int(t) for t in toks[0].flatten() if t >= 0)
        phase += 1
        if phase == cfg.n_phases:
            aligned = np.zeros(b, bool)
            aligned[0] = True
            state = model.compact_state(cfg, state, mask=aligned)
            phase = 0

    while len(rest) >= shift:
        tick(rest[:shift], 1)
        rest = rest[shift:]
        steps += 1
    frames = (256 + len(audio) - 512 + 160) // 160
    nv = (frames - cfg.shift_mel_frames * steps) // cfg.subsampling_factor
    if nv > 0:
        tick(rest, nv)
    return model.tokenizer.decode(ids)


async def _start(model, batch=4):
    srv = StreamServer(model, batch_per_group=batch)
    server = await srv.start("127.0.0.1", 0)
    return srv, server, server.sockets[0].getsockname()[1]


def test_two_tcp_clients_match_direct_tick_loop():
    model = build_model()
    audios = [make_audio(9000, seed=1), make_audio(6500, seed=2)]
    # each stream alone in slot 0 of the same 4-slot batch
    want = [direct_transcript(model, a) for a in audios]
    assert all(want), want

    async def run():
        srv, server, port = await _start(model)
        try:
            return await asyncio.wait_for(asyncio.gather(*[
                transcribe_file(a, host="127.0.0.1", port=port, chunk_ms=100)
                for a in audios]), timeout=120)
        finally:
            await srv.stop(server)

    got = asyncio.run(run())
    assert got == want


def test_server_refuses_what_the_port_does_not_run():
    model = build_model()

    async def run():
        srv, server, port = await _start(model)
        try:
            client = await StreamClient.connect("127.0.0.1", port)
            errors = []
            for cfg in ({"right_context": 5}, {"diarize": True}):
                await client.send(P.OP_STREAM_START, 0, json.dumps(cfg))
                op, _sid, payload = await client.recv()
                errors.append((op, payload.decode()))
            sid = await client.start_stream(0)
            client.close()
            return errors, sid
        finally:
            await srv.stop(server)

    errors, sid = asyncio.run(run())
    assert [op for op, _ in errors] == [P.OP_ERROR] * 2
    assert "must be one of" in errors[0][1]
    assert "diarization not enabled" in errors[1][1]
    assert sid >= 1


@pytest.mark.parametrize("flag, message", [
    (["--native", "--diarize", "d.gguf"], "not supported with --native"),
    (["--dp", "3", "--batch", "8"], "must be divisible by the mesh's dp=3"),
    (["--dp", "0"], "must be at least 1"),
    (["--native", "--tp", "0"], "must be at least 1")])
def test_main_refuses_unported_options(flag, message, capsys):
    """Refused before any model loads: diarization on the native ingest
    server (as in the JAX package), a stream batch that --dp does not divide
    (the JAX package's ValueError, with its words) and a mesh axis below
    1."""
    with pytest.raises(SystemExit) as e:
        main(["random", *flag])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_dp2_tp2_cpu_server_matches_session(tmp_path):
    """main's options --device cpu --dp 2 --tp 2 (after tests/test_server.py:
    272): the model on a 2x2 mesh of ["cpu"] * 4 behind the asyncio server,
    two TCP clients, each text equal to a single-device session's."""
    from scripts_support import export_random_checkpoint

    path = str(tmp_path / "tiny.gguf")
    export_random_checkpoint(tiny_hparams(), path, seed=1)
    args = parse_args([path, "--device", "cpu", "--dp", "2", "--tp", "2",
                       "--batch", "4"])
    model = load_model_from_args(args)
    assert model.mesh.shape == {"dp": 2, "tp": 2}
    assert model.backend_name.startswith("mesh dp=2xtp=2@cpu")
    plain = ASRModel.from_gguf(path, device="cpu")
    audios = [make_audio(9000, seed=5), make_audio(6500, seed=6)]
    want = []
    for a in audios:
        sess = StreamSession(plain, 0)
        sess.process_incremental(a)
        sess.finalize()
        want.append(sess.get_transcript())
    assert all(want), want

    async def run():
        srv, server, port = await _start(model, batch=args.batch)
        try:
            return await asyncio.wait_for(asyncio.gather(*[
                transcribe_file(a, host="127.0.0.1", port=port, chunk_ms=100)
                for a in audios]), timeout=120)
        finally:
            await srv.stop(server)

    assert asyncio.run(run()) == want
