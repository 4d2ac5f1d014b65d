"""The port's engine on a device mesh (after tests/test_engine_mesh.py and
tests/test_engine_migrate.py:213): a BatchedEngine whose model is sharded
over a mesh of ["cpu"] * n gives the same texts as the port's engine on one
device for the same push schedule, with a staggered join, a pause (masked
fast ticks and realign-on-resume) and finalize, at dp x tp = 4x1 and 2x2;
put_batch and the stream state are split over dp, and a batch that dp does
not divide is refused; a mesh state's slots extract to the single
device's leaves byte for byte; a stream exported from a dp = 2 engine
installs into a single-device engine, exports from there to the same
snapshot bytes, and finishes with the text of never moving; a session
on a tp mesh checkpoints into a single-device session and back. The JAX
package's mesh-engine tests are marked slow there, so these hold the
port's mesh against the port's single device; tests/test_torch_mesh.py
holds the sharded step against the JAX package's."""

import numpy as np
import pytest
import torch

from helpers import tiny_hparams

from nemotron_tpu_torch.api import ASRModel
from nemotron_tpu_torch.config import CacheConfig
from nemotron_tpu_torch.ops.kvquant import HeadShards
from nemotron_tpu_torch.parallel.mesh import DPBatch, make_mesh, place
from nemotron_tpu_torch.streaming.engine import (BatchedEngine,
                                                 snapshot_from_bytes,
                                                 snapshot_to_bytes)
from nemotron_tpu_torch.streaming.session import StreamSession
from nemotron_tpu_torch.streaming.state import (MeshState, extract_slots,
                                                install_slot, state_leaves)

torch.set_num_threads(1)

CHUNK = 1600
N_PHASES = 2


@pytest.fixture(autouse=True)
def few_phases(monkeypatch):
    monkeypatch.setitem(CacheConfig._MODE_N_PHASES, 0, N_PHASES)


def make_audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    f = 200 + 50 * (seed % 5)
    sig = 0.4 * np.sin(2 * np.pi * f * t) + 0.2 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


def build_model(mesh=None, seed=1):
    model = ASRModel.random(tiny_hparams(), seed=seed, device="cpu")
    return model if mesh is None else model.shard(
        make_mesh(*mesh, devices=["cpu"] * (mesh[0] * mesh[1])))


def make_schedule(audios, joins, pauses):
    """Per-round actions, as tests/test_engine_mesh.py's: (key, 'start'),
    (key, pcm) or (key, 'end'); joins[k] delays k's start to that round,
    pauses[k] holds the rounds in which k pushes nothing."""
    offs = {k: 0 for k in audios}
    started, ended = set(), set()
    rounds, r = [], 0
    while len(ended) < len(audios):
        acts = []
        for k, a in audios.items():
            if r < joins.get(k, 0) or k in ended:
                continue
            if k not in started:
                acts.append((k, "start"))
                started.add(k)
            if r in pauses.get(k, ()):
                continue
            if offs[k] < len(a):
                acts.append((k, a[offs[k]:offs[k] + CHUNK]))
                offs[k] += CHUNK
            else:
                acts.append((k, "end"))
                ended.add(k)
        rounds.append(acts)
        r += 1
    return rounds


def drive(model, rounds, batch=8):
    engine = BatchedEngine(model, batch_per_group=batch)
    sid, texts, key_of, finals = {}, {}, {}, set()

    def take(events):
        for e in events:
            texts[key_of[e.stream_id]] += e.text
            if e.kind == "ended":
                finals.add(key_of[e.stream_id])

    for acts in rounds:
        for k, act in acts:
            if isinstance(act, str) and act == "start":
                sid[k] = engine.start_stream(0)
                key_of[sid[k]] = k
                texts[k] = ""
            elif isinstance(act, str):
                engine.end_stream(sid[k])
            else:
                engine.push_audio(sid[k], act)
        take(engine.tick()[0])
    for _ in range(100):
        events, more = engine.tick()
        take(events)
        if len(finals) == len(texts) and not more:
            break
    assert len(finals) == len(texts), "streams did not all finalize"
    return texts


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)])
def test_mesh_engine_matches_single_device(mesh):
    audios = {i: make_audio(8000 + 1600 * i, seed=20 + i) for i in range(3)}
    rounds = make_schedule(audios, joins={2: 2}, pauses={1: {3, 4}})
    want = drive(build_model(), rounds)
    assert any(want.values())
    assert drive(build_model(mesh), rounds) == want


def test_put_batch_and_state_are_dp_sharded():
    model = build_model((4, 1))
    x = model.put_batch(np.arange(40, dtype=np.int16).reshape(8, 5))
    assert isinstance(x, DPBatch) and x.shape == (8, 5)
    assert [p.shape for p in x.parts] == [(2, 5)] * 4
    np.testing.assert_array_equal(torch.cat(x.parts).numpy(),
                                  np.arange(40).reshape(8, 5))
    state = model.init_stream_state(8, model.cache_config(0))
    assert isinstance(state, MeshState) and len(state.shards) == 4
    assert all(s.k_cache.shape[1] == 2 and s.conv_cache.shape[1] == 2
               and s.cache_valid.shape == (2,) for s in state.shards)
    with pytest.raises(ValueError, match="dp=4"):
        model.init_stream_state(6, model.cache_config(0))
    with pytest.raises(ValueError, match="dp=4"):
        model.put_batch(np.zeros((6, 5), np.int16))
    # dp x tp: the K/V caches split on their head axis over the tp devices
    tp = build_model((2, 2)).init_stream_state(4, model.cache_config(0))
    heads = tiny_hparams().n_heads
    for s in tp.shards:
        assert isinstance(s.k_cache, HeadShards)
        assert [p.shape[2] for p in s.k_cache.parts] == [heads // 2] * 2


def test_mesh_state_exports_the_single_device_leaves_byte_for_byte():
    """A single-device state placed on a 2x2 mesh (parallel/mesh.place):
    every slot extracts to the same leaves, byte for byte, and installs
    back into either layout."""
    model = build_model()
    cfg = model.cache_config(0)
    state = model.init_stream_state(4, cfg)
    gen = torch.Generator().manual_seed(0)
    for t in state_leaves(state):
        t.copy_((torch.randn(t.shape, generator=gen) * 50).to(t.dtype))
    _, placed = place(model.params, state,
                      make_mesh(2, 2, devices=["cpu"] * 4))
    for a, b in zip(extract_slots(state, range(4)),
                    extract_slots(placed, range(4))):
        for x, y in zip(state_leaves(a), state_leaves(b)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    snap = extract_slots(placed, [3])[0]
    install_slot(placed, 0, snap)
    install_slot(state, 0, snap)
    for x, y in zip(state_leaves(state), state_leaves(placed)):
        assert torch.equal(x, y)


def test_stream_migrates_from_a_dp_mesh_to_one_device():
    """A stream exported from a dp = 2 engine installs into a single-device
    engine; exported again from there before it moves, its snapshot bytes
    are the mesh's; it finishes with the text of never moving."""
    audio = make_audio(9600, seed=8)
    single = build_model()
    engine = BatchedEngine(single, batch_per_group=1)
    sid = engine.start_stream(0)
    want = ""
    for off in range(0, len(audio), CHUNK):
        engine.push_audio(sid, audio[off:off + CHUNK])
        want += "".join(e.text for e in engine.tick()[0])
    engine.end_stream(sid)
    want += "".join(e.text for e in drain(engine))

    mesh_engine = BatchedEngine(build_model((2, 1)), batch_per_group=2)
    mesh_engine.start_stream(0)  # slot 0, shard 0: the stream goes to 1
    sid = mesh_engine.start_stream(0)
    text = ""
    for off in range(0, 4800, CHUNK):
        mesh_engine.push_audio(sid, audio[off:off + CHUNK])
        text += "".join(e.text for e in mesh_engine.tick()[0]
                        if e.stream_id == sid)
    fut = mesh_engine.request_export(sid)
    text += "".join(e.text for e in mesh_engine.tick()[0]
                    if e.stream_id == sid)
    blob = snapshot_to_bytes(fut.result(timeout=10))

    target = BatchedEngine(single, batch_per_group=1)
    fut = target.request_import(snapshot_from_bytes(blob, single))
    target.tick()  # no audio: the slot is masked, its state untouched
    sid2 = fut.result(timeout=10)
    fut = target.request_export(sid2)
    target.tick()
    assert snapshot_to_bytes(fut.result(timeout=10)) == blob
    fut = target.request_import(snapshot_from_bytes(blob, single))
    target.tick()
    sid2 = fut.result(timeout=10)
    for off in range(4800, len(audio), CHUNK):
        target.push_audio(sid2, audio[off:off + CHUNK])
        text += "".join(e.text for e in target.tick()[0])
    target.end_stream(sid2)
    text += "".join(e.text for e in drain(target))
    assert text == want and want


def drain(engine, limit=50):
    out = []
    for _ in range(limit):
        events, more = engine.tick()
        out += events
        if not more:
            return out
    raise AssertionError("engine did not go idle")


def test_session_on_a_tp_mesh_checkpoints_across_topologies(tmp_path):
    """A StreamSession on a dp = 1 x tp = 2 mesh (its state's K/V split on
    the head axis) gives the single device's text; its checkpoint, taken
    mid-stream, resumes in a single-device session, and the single
    device's in a mesh session, each to the same text."""
    audio = make_audio(12800, seed=3)
    single = build_model()
    tp_model = build_model((1, 2))

    def run(model, resume=None, stop=None):
        s = StreamSession(model, 0)
        if resume:
            s.restore_state(resume)
        lo = 6400 if resume else 0
        s.process_incremental(audio[lo:stop or len(audio)])
        if stop:
            path = str(tmp_path / f"ck{id(model)}.npz")
            s.save_state(path)
            return path
        s.finalize()
        return s.get_transcript()

    want = run(single)
    assert want and run(tp_model) == want
    assert run(single, resume=run(tp_model, stop=6400)) == want
    assert run(tp_model, resume=run(single, stop=6400)) == want
