"""Live-stream migration in the port (after tests/test_engine_migrate.py,
without its dp-mesh case): a stream exported mid-flight from one engine and
imported into another at a different slack-buffer phase, through the
snapshot bytes, goes on to the transcript of never moving, in f32, with
int8 K/V, in bf16 and with Q8_0 weights; an ending stream finalizes on the
importer; unknown and finalizing streams are refused at export; a foreign
checkpoint (the weights fingerprint), a mismatched config, a foreign-shaped
state and a live stream id are refused at import, without leaking a slot.

Across packages, on the same random tiny weights (tests/helpers.
tiny_hparams, seed 1): a JAX engine's snapshot bytes install into the
port's engine and the port's into the JAX engine, and each continues to
the JAX engine's unmigrated transcript; both weights fingerprints are
equal. The JAX package compiles a tick per phase, so every engine of this
file runs right context 0 with N_PHASES slack-buffer phases."""

import dataclasses

import numpy as np
import pytest
import torch

from helpers import tiny_hparams

from nemotron_tpu.api import ASRModel as JaxModel
from nemotron_tpu.config import CacheConfig as JaxCacheConfig
from nemotron_tpu.streaming import engine as jax_engine
from nemotron_tpu_torch.api import ASRModel as TorchModel
from nemotron_tpu_torch.config import CacheConfig
from nemotron_tpu_torch.params import quantize_encoder_layers
from nemotron_tpu_torch.streaming.engine import (BatchedEngine,
                                                 snapshot_from_bytes,
                                                 snapshot_to_bytes)

torch.set_num_threads(1)

N_PHASES = 2
PUSH = 1600  # samples per push, one push per tick (1.25 chunks)


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
    f = 200 + 50 * (seed % 5)
    sig = 0.4 * np.sin(2 * np.pi * f * t) + 0.2 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


def torch_model(**kw):
    return TorchModel.random(tiny_hparams(), seed=1, device="cpu", **kw)


def push_ticks(engine, sid, audio, lo, hi, texts):
    """Push audio[lo:hi] PUSH samples per tick; collect event texts."""
    for off in range(lo, hi, PUSH):
        engine.push_audio(sid, audio[off:min(off + PUSH, hi)])
        collect(engine.tick()[0], texts)


def collect(events, texts):
    for e in events:
        texts[e.stream_id] = texts.get(e.stream_id, "") + e.text


def run_to_end(engine, texts, limit=200):
    ended = set()
    for _ in range(limit):
        events, more = engine.tick()
        collect(events, texts)
        ended |= {e.stream_id for e in events if e.kind == "ended"}
        if not more:
            return ended
    raise AssertionError("engine did not go idle")


def unmigrated(engine, audio):
    """The transcript of `audio` pushed PUSH samples per tick, then ended."""
    texts = {}
    sid = engine.start_stream(0)
    push_ticks(engine, sid, audio, 0, len(audio), texts)
    engine.end_stream(sid)
    run_to_end(engine, texts)
    return texts[sid]


def migrate(exporter, importer, audio, cut, decoy_audio, to_bytes,
            from_bytes):
    """The stream of `audio` runs on `exporter` up to sample `cut`, is
    exported through the bytes and imported into `importer`, which hosts a
    decoy stream at another slack-buffer phase, and runs to its end there.
    Returns (stream text, decoy text, the snapshot)."""
    texts_b = {}
    decoy = importer.start_stream(0)
    push_ticks(importer, decoy, decoy_audio, 0, 2 * PUSH, texts_b)
    texts_a = {}
    sid = exporter.start_stream(0)
    push_ticks(exporter, sid, audio, 0, cut, texts_a)
    fut = exporter.request_export(sid)
    collect(exporter.tick()[0], texts_a)  # the export drains the readbacks
    snap = fut.result(timeout=10)
    assert snap["transcript"] == texts_a.get(sid, "")
    with pytest.raises(KeyError):
        exporter.request_export(sid)  # the stream has left
    snap = from_bytes(to_bytes(snap))
    assert int(snap["phase"]) != importer.groups[0].phase  # realign runs
    fut = importer.request_import(snap)
    collect(importer.tick()[0], texts_b)
    sid2 = fut.result(timeout=10)
    texts_b[sid2] = texts_a.get(sid, "") + texts_b.get(sid2, "")
    push_ticks(importer, sid2, audio, cut, len(audio), texts_b)
    importer.end_stream(sid2)
    importer.push_audio(decoy, decoy_audio[2 * PUSH:])
    importer.end_stream(decoy)
    assert {sid2, decoy} <= run_to_end(importer, texts_b)
    return texts_b[sid2], texts_b[decoy], snap


AUDIO = make_audio(12800, seed=3)
DECOY = make_audio(6400, seed=9)
CUT = 3 * PUSH  # 3 chunks: the exporter sits at phase 1, the decoy's at 0

FORMS = {
    "f32": {},
    "int8-kv": {"kv_int8": True},
    "bf16": {"dtype": torch.bfloat16},
}


@pytest.mark.parametrize("form", [*FORMS, "q8"])
def test_stream_migrates_mid_flight_through_bytes(form):
    if form == "q8":
        base = torch_model()
        model = TorchModel(base.hp, quantize_encoder_layers(base.params),
                           base.tokenizer.vocab, device="cpu")
    else:
        model = torch_model(**FORMS[form])
    want = unmigrated(BatchedEngine(model, 2), AUDIO)
    want_decoy = unmigrated(BatchedEngine(model, 2), DECOY)
    assert want, "the test audio emitted no text"
    got, decoy, snap = migrate(
        BatchedEngine(model, 2), BatchedEngine(model, 2), AUDIO, CUT, DECOY,
        snapshot_to_bytes, lambda b: snapshot_from_bytes(b, model))
    assert got == want
    assert decoy == want_decoy  # the import leaves its neighbour alone
    assert snap["kv_int8"] == (form == "int8-kv")


def test_ending_stream_migrates_and_finalizes_remotely():
    """END reached the exporter before the finalize chunk ran: the importer
    finalizes from the carried bookkeeping (total_pushed, steps)."""
    model = torch_model()
    audio = make_audio(7000, seed=4)  # not chunk aligned
    want = unmigrated(BatchedEngine(model, 1), audio)
    engine_a, engine_b = BatchedEngine(model, 1), BatchedEngine(model, 1)
    texts = {}
    sid = engine_a.start_stream(0)
    for off in range(0, len(audio), 1750):
        engine_a.push_audio(sid, audio[off:off + 1750])
        collect(engine_a.tick()[0], texts)
    engine_a.end_stream(sid)
    fut = engine_a.request_export(sid)
    collect(engine_a.tick()[0], texts)
    snap = fut.result(timeout=10)
    assert snap["ending"] is True and len(snap["stage"])
    fut = engine_b.request_import(snap)
    events = engine_b.tick()[0]
    sid2 = fut.result(timeout=10)
    texts = {sid2: texts.get(sid, "")}
    collect(events, texts)
    ended = run_to_end(engine_b, texts) | {
        e.stream_id for e in events if e.kind == "ended"}
    assert sid2 in ended
    assert texts[sid2] == want


def test_export_refuses_unknown_and_finalizing_streams():
    engine = BatchedEngine(torch_model(), 1)
    with pytest.raises(KeyError):
        engine.request_export(12345)
    sid = engine.start_stream(0)
    engine.push_audio(sid, make_audio(3200, seed=5))
    engine.tick()
    # the same stream asked twice before a tick: the second finds it gone
    first, again = engine.request_export(sid), engine.request_export(sid)
    engine.tick()
    with pytest.raises(KeyError):
        again.result(timeout=10)
    fut = engine.request_import(first.result(timeout=10), stream_id=sid)
    engine.tick()
    assert fut.result(timeout=10) == sid
    # a finalize dispatched but not yet read back: simulate the race
    group = engine.groups[0]
    group.slots[group.find(sid)].finalize_sent = True
    fut = engine.request_export(sid)
    engine.tick()
    with pytest.raises(RuntimeError, match="too late to export"):
        fut.result(timeout=10)


def exported(model):
    engine = BatchedEngine(model, 1)
    sid = engine.start_stream(0)
    engine.push_audio(sid, make_audio(3200, seed=12))
    engine.tick()
    fut = engine.request_export(sid)
    engine.tick()
    return fut.result(timeout=10)


def test_import_refuses_foreign_or_mismatched_snapshots():
    model = torch_model()
    snap = exported(model)
    other = TorchModel.random(tiny_hparams(), seed=2, device="cpu")
    assert other.weights_fingerprint != model.weights_fingerprint
    engine = BatchedEngine(other, 2)
    for bad, err, match in (
            (snap, ValueError, "fingerprint"),
            ({**snap, "n_phases": N_PHASES + 1}, ValueError, "n_phases"),
            ({**snap, "version": 2}, ValueError, "version"),
            ({**snap, "kv_int8": True}, ValueError, "kv-int8"),
            ({**snap, "state": dataclasses.replace(
                snap["state"], conv_cache=snap["state"].conv_cache[:, :, :1])},
             ValueError, "shape")):
        fut = engine.request_import(bad, trust_model=bad is not snap)
        engine.tick()
        with pytest.raises(err, match=match):
            fut.result(timeout=10)
        assert engine.groups[0].n_active_streams == 0  # no slot leaked
    # a trusted import of the foreign snapshot installs (a hot swap's case)
    fut = engine.request_import(snap, stream_id=7, trust_model=True)
    engine.tick()
    assert fut.result(timeout=10) == 7
    with pytest.raises(ValueError, match="already live"):
        engine.request_import(snap, stream_id=7)
    assert engine.start_stream(0) == 8  # the id counter skipped past 7
    fut = engine.request_import(snap, trust_model=True)
    engine.tick()
    with pytest.raises(RuntimeError, match="no free stream slots"):
        fut.result(timeout=10)
    with pytest.raises(ValueError, match="kv-int8"):
        snapshot_from_bytes(snapshot_to_bytes(snap), torch_model(kv_int8=True))


# --- across packages ---------------------------------------------------------
@pytest.fixture(scope="module")
def jax_model():
    return JaxModel.random(tiny_hparams(), seed=1)


@pytest.fixture(scope="module")
def jax_want(jax_model):
    """The JAX engine's unmigrated transcripts of AUDIO and DECOY."""
    return {name: unmigrated(jax_engine.BatchedEngine(jax_model, 2), a)
            for name, a in (("audio", AUDIO), ("decoy", DECOY))}


def test_weights_fingerprints_are_equal_across_packages(jax_model):
    model = torch_model()
    assert model.weights_fingerprint == jax_model.weights_fingerprint
    assert TorchModel.random(tiny_hparams(), seed=2, device="cpu") \
        .weights_fingerprint != jax_model.weights_fingerprint


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_snapshot_bytes_cross_between_packages(jax_model, jax_want,
                                               direction):
    model = torch_model()
    jax_side = (jax_engine.BatchedEngine(jax_model, 2),
                jax_engine.snapshot_to_bytes,
                lambda b: jax_engine.snapshot_from_bytes(b, jax_model))
    port_side = (BatchedEngine(model, 2), snapshot_to_bytes,
                 lambda b: snapshot_from_bytes(b, model))
    src, dst = ((jax_side, port_side) if direction == "jax-to-port"
                else (port_side, jax_side))
    exporter, to_bytes, importer, from_bytes = src[0], src[1], dst[0], dst[2]
    got, decoy, snap = migrate(exporter, importer, AUDIO, CUT, DECOY,
                               to_bytes, from_bytes)
    assert jax_want["audio"], "the test audio emitted no text"
    assert got == jax_want["audio"]
    assert decoy == jax_want["decoy"]
    # the port's unmigrated run agrees too
    assert unmigrated(BatchedEngine(model, 2), AUDIO) == jax_want["audio"]


def test_legacy_flow_export_after_a_gated_tick():
    """In the legacy flow a tick with a paused slot first compacts every
    window to phase 0: a stream exported right after it carries phase 0
    (the JAX engine keeps the old phase there, ROADMAP §3) and continues
    on another engine to the unmigrated transcript."""
    model = torch_model()
    audio, other = make_audio(12800, seed=6), make_audio(12800, seed=7)

    def run(export):
        engine = BatchedEngine(model, 2, gated_realign=False)
        texts = {}
        s1, s2 = engine.start_stream(0), engine.start_stream(0)
        for sid, a in ((s1, audio), (s2, other)):
            engine.push_audio(sid, a[:96 + 3 * 1280])
        for _ in range(3):  # all-active ticks: the group reaches phase 1
            collect(engine.tick()[0], texts)
        engine.push_audio(s1, audio[96 + 3 * 1280:96 + 4 * 1280])
        collect(engine.tick()[0], texts)  # s2 starves: a gated tick
        group = engine.groups[0]
        assert group.phase == 0 and group.total_steps == 3
        if export:
            fut = engine.request_export(s1)
            collect(engine.tick()[0], texts)
            snap = fut.result(timeout=10)
            assert snap["phase"] == 0
            engine_b = BatchedEngine(model, 2)  # masked ticks advance
            decoy = engine_b.start_stream(0)
            engine_b.push_audio(decoy, other[:96 + 1280])
            engine_b.tick()
            assert engine_b.groups[0].phase == 1  # the import rolls
            fut = engine_b.request_import(snapshot_from_bytes(
                snapshot_to_bytes(snap), model))
            engine_b.tick()
            s1b = fut.result(timeout=10)
            texts = {s1b: texts.get(s1, "")}
            engine, s1 = engine_b, s1b
        engine.push_audio(s1, audio[96 + 4 * 1280:])
        engine.end_stream(s1)
        run_to_end(engine, texts)
        return texts[s1]

    want = run(False)
    assert want and run(True) == want
