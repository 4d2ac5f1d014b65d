"""The port's server on the CPU: two TCP clients, each transcript equal to the
port's direct tick loop over the same audio (tokens are exact, not within a
tolerance), plus the refusals the port makes at START (a right context
outside 0, 1, 6, 13; diarization on a server without a diarize model) and
in main (--diarize with --native, multi-GPU serving). Right contexts 1, 6
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
from nemotron_tpu_torch.serving.server import StreamServer, main
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
    (["--dp", "2"], "not supported by the torch port"),
    (["--tp", "2"], "not supported by the torch port"),
    (["--native", "--tp", "2"], "not supported by the torch port")])
def test_main_refuses_unported_options(flag, message, capsys):
    """Refused before any model loads: multi-GPU serving (not ported yet)
    and diarization on the native ingest server (as in the JAX package)."""
    with pytest.raises(SystemExit) as e:
        main(["random", *flag])
    assert e.value.code == 2
    assert message in capsys.readouterr().err
