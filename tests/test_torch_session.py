"""The port's StreamSession against the JAX package's on one tiny GGUF and one
PCM, with and without the fused attention block (kernel B3; the JAX
package's Pallas block in interpret mode): delta texts, tokens, token frames
and transcripts equal for regular and irregular pushes, a language switch,
a second finalize and a reset; timed words; save/restore mid-stream equal
to an uninterrupted run; a JAX session's checkpoint resumed in the port
(f32 and int8 K/V); the port's checkpoints, written in the JAX layout,
resumed in the JAX session (f32 and int8 K/V at right contexts 0 and 13)
and, in bf16, in the port (the JAX session cannot restore a bf16
checkpoint, its own included: np.load gives its bfloat16 leaves back as
2-byte void records, which jnp.asarray refuses); the packed per-token
confidences; and the legacy gated stream step with per-slot prompts, and a
confidence engine's events.

The JAX package compiles one step function per phase and model, so each
JAX configuration runs all its scenarios once (a module fixture) and the
tests compare the port against those results, and every session runs at
right context 0 with N_PHASES slack-buffer phases (a wrap every N_PHASES
chunks) in place of the default 8."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_hparams
from scripts_support import export_random_checkpoint

from nemotron_tpu.api import ASRModel as JaxModel
from nemotron_tpu.models import encoder as ENC
from nemotron_tpu.streaming.session import StreamSession as JaxSession
from nemotron_tpu_torch.api import ASRModel as TorchModel
from nemotron_tpu_torch.streaming.session import StreamSession
from nemotron_tpu_torch.streaming.state import state_leaves

torch.set_num_threads(1)

PROMPTS = {"en-US": 0, "ru-RU": 2, "auto": 3}
N_PHASES = 2


def make_audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.2 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


AUDIO = make_audio(16000, seed=11)
IRREGULAR = np.cumsum(np.random.default_rng(5).integers(37, 3000, 40))


def feed(sess, cuts):
    deltas, prev = [], 0
    for c in [*cuts[cuts < len(AUDIO)], len(AUDIO)]:
        deltas.append(sess.process_incremental(AUDIO[prev:c]))
        prev = c
    return deltas + [sess.finalize()]


def summary(sess, deltas):
    return dict(deltas=deltas, tokens=sess.get_tokens(),
                frames=list(sess.token_frames),
                transcript=sess.get_transcript(), words=sess.timed_words())


def cfg_of(model):
    """Right context 0 with N_PHASES phases, in the model's package."""
    return dataclasses.replace(model.cache_config(0), n_phases=N_PHASES)


def scenarios(Session, model) -> dict:
    """Every scenario of this file on one model of either package."""
    out = {}
    cfg = cfg_of(model)
    s = Session(model, cfg, lang="en-US")
    out["regular"] = summary(s, feed(s, np.arange(1280, len(AUDIO), 1280)))
    s = Session(model, cfg, lang="en-US")
    out["irregular"] = summary(s, feed(s, IRREGULAR))
    s = Session(model, cfg, lang="en-US", timestamp_words=True)
    out["timestamps"] = summary(s, feed(s, np.array([7000])))
    s = Session(model, cfg, lang="en-US")
    deltas = [s.process_incremental(AUDIO[:4800])]
    assert s.set_language("ru-RU") and not s.set_language("xx-XX")
    deltas += [s.process_incremental(AUDIO[4800:]), s.finalize(),
               s.finalize()]
    out["switch"] = summary(s, deltas)
    s.reset()  # keeps the language
    out["after_reset"] = summary(s, feed(s, np.array([3000, 9000])))
    return out


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("session") / "tiny.gguf")
    export_random_checkpoint(tiny_hparams(num_prompts=4), path, seed=3)
    return path


def jax_model(path):
    model = JaxModel.from_gguf(path)
    model.prompt_dict = dict(PROMPTS)
    return model


def torch_model(path, **kw):
    model = TorchModel.from_gguf(path, device="cpu", **kw)
    model.prompt_dict = dict(PROMPTS)
    return model


@pytest.fixture(scope="module")
def jax_runs(gguf):
    """block -> the JAX package's results, its block flag set while its
    step functions trace and run."""
    cache = {}

    def get(block):
        if block not in cache:
            old = ENC.PALLAS_ATTN_BLOCK
            ENC.PALLAS_ATTN_BLOCK = block
            try:
                cache[block] = scenarios(JaxSession, jax_model(gguf))
            finally:
                ENC.PALLAS_ATTN_BLOCK = old
        return cache[block]

    return get


@pytest.mark.parametrize("block", [False, True], ids=["default", "block"])
def test_session_matches_jax(gguf, jax_runs, block):
    want = jax_runs(block)
    got = scenarios(StreamSession, torch_model(gguf, attn_block=block))
    assert want["regular"]["tokens"], "the test audio emitted no tokens"
    assert want["switch"]["tokens"] != want["regular"]["tokens"]
    for name in want:
        assert got[name] == want[name], name
    # pushes and chunking never change the result
    for name in ("irregular", "timestamps"):
        assert got[name]["tokens"] == got["regular"]["tokens"]


def test_save_restore_mid_stream_matches_an_uninterrupted_run(gguf, jax_runs,
                                                              tmp_path):
    model = torch_model(gguf)
    s1 = StreamSession(model, cfg_of(model), lang="en-US")
    s1.process_incremental(AUDIO[:7000])
    path = str(tmp_path / "stream_state.npz")
    s1.save_state(path)
    s2 = StreamSession(model, cfg_of(model))
    s2.restore_state(path)
    tail = s2.process_incremental(AUDIO[7000:]) + s2.finalize()
    want = jax_runs(False)["timestamps"]  # pushed as 7000 + the rest
    assert s2.get_tokens() == want["tokens"]
    assert s2.token_frames == want["frames"]
    assert s2.get_transcript() == s1.get_transcript() + tail
    assert s2.prompt_index == PROMPTS["en-US"] and s2.rtf() > 0.0


def test_packed_confidences_match_jax(gguf):
    old = os.environ.get("NEMOTRON_TPU_CONFIDENCE")
    os.environ["NEMOTRON_TPU_CONFIDENCE"] = "1"
    try:
        jm = jax_model(gguf)
        js = JaxSession(jm, cfg_of(jm), lang="en-US")
        js.process_incremental(AUDIO)
        js.finalize()
        want_words = js.timed_words_conf()
    finally:
        if old is None:
            del os.environ["NEMOTRON_TPU_CONFIDENCE"]
        else:
            os.environ["NEMOTRON_TPU_CONFIDENCE"] = old
    tm = torch_model(gguf, confidence=True)
    ts = StreamSession(tm, cfg_of(tm), lang="en-US")
    ts.process_incremental(AUDIO)
    ts.finalize()
    assert js.token_confs and ts.token_confs == js.token_confs
    assert ts.get_tokens() == js.get_tokens()
    assert ts.get_transcript() == js.get_transcript()
    assert ts.timed_words_conf() == want_words
    tm = torch_model(gguf)
    plain = StreamSession(tm, cfg_of(tm), lang="en-US")
    plain.process_incremental(AUDIO)
    plain.finalize()
    assert plain.get_tokens() == ts.get_tokens()
    with pytest.raises(RuntimeError, match="confidence"):
        plain.timed_words_conf()


def test_gated_stream_step_and_engine_confidence_match_jax(gguf, jax_runs):
    """The phase-stationary gated stream step (a language prompt per slot)
    gives JAX's tokens and leaves paused slots untouched; a confidence=True
    model builds an engine whose text events carry conf in (0, 1]."""
    import jax

    from nemotron_tpu_torch.streaming.engine import BatchedEngine
    from nemotron_tpu_torch.streaming.state import state_leaves

    jm, tm = jax_model(gguf), torch_model(gguf)
    jcfg, tcfg = cfg_of(jm), cfg_of(tm)
    rng = np.random.default_rng(8)
    mel = rng.standard_normal(
        (2, 3, tcfg.chunk_mel_frames, tm.hp.n_mels)).astype(np.float32)
    nv = np.full(3, tcfg.valid_out_len, np.int32)
    prompt = np.array([0, 2, 3], np.int32)
    j_state, t_state = jm.init_stream_state(3, jcfg), \
        tm.init_stream_state(3, tcfg)
    for step, act in enumerate((None, np.array([True, False, True]))):
        before = [t.clone() for t in state_leaves(t_state)]
        j_state, j_tok = jm.stream_step(jcfg, j_state, mel[step], nv, act,
                                        prompt, phase=1)
        t_state, t_tok = tm.stream_step(
            tcfg, t_state, torch.tensor(mel[step]), torch.tensor(nv),
            None if act is None else torch.tensor(act),
            torch.tensor(prompt), phase=1)
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
        for t, j in zip(state_leaves(t_state), jax.tree.leaves(j_state)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)
    # the paused slot: the caches at axis 1, the rest at axis 0
    for n, (t, b) in enumerate(zip(state_leaves(t_state), before)):
        assert torch.equal(t.select(int(n < 3), 1), b.select(int(n < 3), 1))

    engine = BatchedEngine(torch_model(gguf, confidence=True), 2)
    sid = engine.start_stream(0, lang="en-US")
    engine.push_audio(sid, AUDIO)
    engine.end_stream(sid)
    events = []
    for _ in range(100):
        ev, more = engine.tick()
        events.extend(ev)
        if not more:
            break
    texts = [e for e in events if e.text]
    assert texts and all(0.0 < e.conf <= 1.0 for e in texts)
    assert "".join(e.text for e in events) == \
        jax_runs(False)["regular"]["transcript"]


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8-kv"])
def test_jax_checkpoint_resumes_in_the_port(gguf, tmp_path, monkeypatch,
                                            kv_int8):
    """A JAX StreamSession.save_state checkpoint (leaf_{i} keys, no
    confidences) restores into the port's session, which continues to the
    tokens the JAX session gives after the same checkpoint."""
    monkeypatch.setenv("NEMOTRON_TPU_KV_INT8", "1" if kv_int8 else "0")
    jm = jax_model(gguf)
    js = JaxSession(jm, cfg_of(jm), lang="en-US")
    js.process_incremental(AUDIO[:7000])
    path = str(tmp_path / "jax_state.npz")
    js.save_state(path)
    js.process_incremental(AUDIO[7000:])
    js.finalize()
    assert js.get_tokens()
    tm = torch_model(gguf, kv_int8=kv_int8)
    ts = StreamSession(tm, cfg_of(tm))
    ts.restore_state(path)
    assert ts.prompt_index == PROMPTS["en-US"] and ts.token_confs == []
    ts.process_incremental(AUDIO[7000:])
    ts.finalize()
    assert ts.get_tokens() == js.get_tokens()
    assert ts.token_frames == js.token_frames
    assert ts.get_transcript() == js.get_transcript()
    if not kv_int8:  # the checkpoint's state leaves against the JAX ones
        with pytest.raises(ValueError, match="kv-int8"):
            StreamSession(torch_model(gguf, kv_int8=True),
                          cfg_of(tm)).restore_state(path)


LONG = np.concatenate([AUDIO, make_audio(20000, seed=12)])


@pytest.mark.parametrize("rc, kv_int8", [(0, False), (0, True), (13, False),
                                         (13, True)],
                         ids=["r0-f32", "r0-int8-kv", "r13-f32",
                              "r13-int8-kv"])
def test_port_checkpoint_resumes_in_jax(gguf, tmp_path, monkeypatch, rc,
                                        kv_int8):
    """A port StreamSession.save_state checkpoint (the JAX layout: n_leaves,
    leaf_{i} in the pytree order and dtypes, JAX's other keys) restores
    into the JAX package's session, which continues to the port's tokens."""
    monkeypatch.setenv("NEMOTRON_TPU_KV_INT8", "1" if kv_int8 else "0")
    cut = 7000 if rc == 0 else 25000  # past the first R=13 chunk
    tm = torch_model(gguf, kv_int8=kv_int8)
    cfg = cfg_of(tm) if rc == 0 else tm.cache_config(13)
    ts = StreamSession(tm, cfg, lang="en-US")
    ts.process_incremental(LONG[:cut])
    assert rc == 0 or ts.total_chunks >= 1
    path = str(tmp_path / "port_state.npz")
    ts.save_state(path)
    ts.process_incremental(LONG[cut:])
    ts.finalize()
    assert ts.get_tokens()
    z = np.load(path)
    assert {"n_leaves", "mel_buffer", "pp_buf", "pp_last", "tokens",
            "token_frames", "transcript", "prompt_index",
            "total_audio_seconds", "total_chunks", "phase",
            "token_confs"} <= set(z.files)
    jm = jax_model(gguf)
    js = JaxSession(jm, cfg_of(jm) if rc == 0 else jm.cache_config(13))
    js.restore_state(path)
    assert js.prompt_index == PROMPTS["en-US"]
    js.process_incremental(LONG[cut:])
    js.finalize()
    assert js.get_tokens() == ts.get_tokens()
    assert js.token_frames == ts.token_frames
    assert js.get_transcript() == ts.get_transcript()


def test_port_bf16_checkpoint_restores_in_the_port(gguf, tmp_path):
    """bf16: the port writes its bf16 leaves as the JAX session writes its
    own (2-byte void records, the same leaf dtypes in every position) and
    restores them bit for bit; the resumed session continues to the tokens
    of an uninterrupted one."""
    tm = torch_model(gguf, dtype=torch.bfloat16)
    s1 = StreamSession(tm, cfg_of(tm), lang="en-US")
    s1.process_incremental(AUDIO[:7000])
    path = str(tmp_path / "bf16_state.npz")
    s1.save_state(path)
    saved = [t.clone() for t in state_leaves(s1.state)]
    s1.process_incremental(AUDIO[7000:])
    s1.finalize()

    jm = JaxModel.from_gguf(gguf, dtype=jnp.bfloat16)
    js = JaxSession(jm, cfg_of(jm), lang="en-US")
    js.process_incremental(AUDIO[:7000])
    jpath = str(tmp_path / "jax_bf16_state.npz")
    js.save_state(jpath)
    zp, zj = np.load(path), np.load(jpath)
    n = int(zj["n_leaves"])
    assert int(zp["n_leaves"]) == n
    assert [zp[f"leaf_{i}"].dtype for i in range(n)] \
        == [zj[f"leaf_{i}"].dtype for i in range(n)]
    assert any(zp[f"leaf_{i}"].dtype.kind == "V" for i in range(n))

    s2 = StreamSession(tm, cfg_of(tm))
    s2.restore_state(path)
    for a, b in zip(state_leaves(s2.state), saved):
        assert a.dtype == b.dtype and torch.equal(a, b)
    s2.process_incremental(AUDIO[7000:])
    s2.finalize()
    assert s2.get_tokens() == s1.get_tokens()
    assert s2.get_transcript() == s1.get_transcript()
