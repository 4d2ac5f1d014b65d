"""The port's diarization (nemotron_tpu_torch/diarize/) against the JAX
package's on the CPU, on the random diarize checkpoint of
tests/scripts_support.export_random_diarize_checkpoint (seed 7, the
published MarbleNet / TitaNet-L widths) and seed-made audio:

  - the loader: every folded leaf equal to the JAX package's, and
    diarize_params_from_numpy (the bridge from JAX's DiarizeModelParams)
    equal to the port's own load;
  - the 80-mel frontend within JAX's own rules (2e-4 for the VAD's, 5e-4
    for the speaker net's normalised one, tests/test_diarize.py), the VAD
    probabilities within 1e-4 and the embeddings within 5e-4 x max(1,
    max|e|), over full and ragged lengths (B <= 4);
  - both nets against tests/torch_diarize_oracle.py (torch.stft, Conv1d,
    BatchNorm1d on the raw GGUF tensors) within the rules of
    tests/test_diarize_oracle.py;
  - NME-SC: the speaker count and the labels equal on JAX's synthetic
    embeddings and on embeddings of the port's TitaNet, and the batched
    eigengap sweep's choice;
  - the pipeline: segments, sub-segments, words, word JSON, RTTM, speaker
    text and speaker count equal with injected vad_fn / spk_fn (the state
    machine, drip-fed) and with the nets (one push, so each net runs at
    one batch shape); the offline vad_extract_segments equal."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts_support import export_random_diarize_checkpoint
from torch_diarize_oracle import TorchSpkOracle, TorchVadOracle

from nemotron_tpu.diarize import audio as jaudio
from nemotron_tpu.diarize import cluster as jcluster
from nemotron_tpu.diarize import nets as jnets
from nemotron_tpu.diarize import pipeline as jpipe
from nemotron_tpu.diarize.params import load_diarize_model as jload
from nemotron_tpu.gguf.reader import read_gguf
from nemotron_tpu_torch.diarize import audio as taudio
from nemotron_tpu_torch.diarize import cluster as tcluster
from nemotron_tpu_torch.diarize import nets as tnets
from nemotron_tpu_torch.diarize import pipeline as tpipe
from nemotron_tpu_torch.diarize.params import (diarize_params_from_numpy,
                                               load_diarize_model)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("diarize") / "diarize.gguf")
    export_random_diarize_checkpoint(path, seed=7)
    return {"path": path, "jax": jload(path),
            "port": load_diarize_model(path, device="cpu"),
            "raw": read_gguf(path).load_all()}


def make_audio(n, seed=0, freq=300.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = 0.4 * np.sin(2 * np.pi * freq * t) + 0.1 * rng.standard_normal(n)
    return np.clip(sig, -1, 1).astype(np.float32)


def windows(n, lens, seed):
    """len(lens) windows of n samples, each zero past its length."""
    w = np.stack([make_audio(n, seed + i, 200.0 + 350 * i)
                  for i in range(len(lens))])
    for i, ln in enumerate(lens):
        w[i, ln:] = 0.0
    return w, np.asarray(lens, np.int32)


def _leaves(obj, prefix=""):
    """{dotted name: numpy} over a params tree of either package."""
    out = {}
    if isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            out.update(_leaves(v, f"{prefix}{i}."))
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if f.name in ("kv", "device"):
                continue
            out.update(_leaves(getattr(obj, f.name), f"{prefix}{f.name}."))
    elif obj is not None:
        out[prefix[:-1]] = np.asarray(obj.cpu() if isinstance(
            obj, torch.Tensor) else obj)
    return out


def test_loader_folds_as_jax_and_the_bridge_equals_the_load(ckpt):
    want = _leaves(ckpt["jax"])
    got = _leaves(ckpt["port"])
    assert got.keys() == want.keys() and len(got) > 100
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bridged = diarize_params_from_numpy(ckpt["jax"], device="cpu")
    assert _leaves(bridged).keys() == got.keys()
    for k, v in _leaves(bridged).items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    assert ckpt["port"].kv == ckpt["jax"].kv
    assert ckpt["port"].device == torch.device("cpu")


def test_vad_frontend_and_probs_match_jax(ckpt):
    w, lens = windows(taudio.VAD_WINDOW_SAMPLES, [10080, 5000, 10080, 9000],
                      seed=1)
    jp, tp = ckpt["jax"].vad, ckpt["port"].vad
    jm = np.asarray(jaudio.logmel(jnp.asarray(w), jp.fb, jp.window, False))
    tm = taudio.logmel(torch.from_numpy(w), tp.fb, tp.window, False).numpy()
    assert tm.shape == jm.shape == (4, taudio.VAD_MEL_PADDED, 80)
    assert np.abs(tm - jm).max() < 2e-4
    want = np.asarray(jnets.vad_probs(jp, jnp.asarray(w), jnp.asarray(lens)))
    got = tnets.vad_probs(tp, torch.from_numpy(w),
                          torch.from_numpy(lens)).numpy()
    assert got.shape == (4,) and np.all((got >= 0) & (got <= 1))
    assert np.abs(got - want).max() < 1e-4


def test_spk_frontend_and_embeddings_match_jax(ckpt):
    w, lens = windows(taudio.SPK_WINDOW_SAMPLES, [24000, 9000], seed=4)
    jp, tp = ckpt["jax"].spk, ckpt["port"].spk
    jm = np.asarray(jaudio.logmel(jnp.asarray(w), jp.fb, jp.window, True))
    tm = taudio.logmel(torch.from_numpy(w), tp.fb, tp.window, True).numpy()
    assert tm.shape == jm.shape == (2, taudio.SPK_MEL_PADDED, 80)
    assert np.abs(tm - jm).max() < 5e-4
    want = np.asarray(jnets.spk_embed(jp, jnp.asarray(w), jnp.asarray(lens)))
    got = tnets.spk_embed(tp, torch.from_numpy(w),
                          torch.from_numpy(lens)).numpy()
    assert got.shape == (2, 192)
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 5e-4


def test_nets_match_the_torch_oracle(ckpt):
    """The rules of tests/test_diarize_oracle.py: VAD within 1e-3, each
    embedding within 2e-3 of its largest magnitude."""
    tp = ckpt["port"]
    w, lens = windows(taudio.VAD_WINDOW_SAMPLES, [10080, 5000], seed=2)
    want = TorchVadOracle(ckpt["raw"])(w, lens)
    got = tnets.vad_probs(tp.vad, torch.from_numpy(w),
                          torch.from_numpy(lens)).numpy()
    assert np.abs(got - want).max() < 1e-3
    w, lens = windows(taudio.SPK_WINDOW_SAMPLES, [24000, 9000], seed=5)
    want = TorchSpkOracle(ckpt["raw"])(w, lens)
    got = tnets.spk_embed(tp.spk, torch.from_numpy(w),
                          torch.from_numpy(lens)).numpy()
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.max(np.abs(got - want) / scale) < 2e-3


def _clusters(k, per, dim, noise, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    pts = np.concatenate([c + noise * rng.standard_normal((per, dim))
                          for c in centers])
    return pts / np.linalg.norm(pts, axis=1, keepdims=True)


NMESC_CASES = {
    "three_speakers": (lambda: _clusters(3, 40, 192, 0.05, 0),
                       dict(kmeans_seed=3)),
    "two_speakers_noisy": (lambda: _clusters(2, 25, 192, 0.6, 4), {}),
    "oracle_two": (lambda: np.random.default_rng(1).standard_normal(
        (30, 192)).astype(np.float32), dict(oracle_num_speakers=2)),
    "small_n": (lambda: np.random.default_rng(2).standard_normal(
        (4, 192)).astype(np.float32), {}),
    "fixed_threshold": (lambda: _clusters(4, 12, 32, 0.2, 5),
                        dict(fixed_thres=0.3, kmeans_random_trials=3)),
}


@pytest.mark.parametrize("case", list(NMESC_CASES))
def test_nmesc_matches_jax_on_synthetic_embeddings(case):
    make, kw = NMESC_CASES[case]
    emb = make()
    want = jcluster.nmesc_cluster(emb, jcluster.NmescConfig(**kw))
    got = tcluster.nmesc_cluster(emb, tcluster.NmescConfig(**kw))
    assert got.est_num_speakers == want.est_num_speakers
    assert got.p_hat == want.p_hat
    np.testing.assert_array_equal(got.labels, want.labels)
    if case == "three_speakers":
        assert got.est_num_speakers == 3


def test_eigengap_sweep_matches_jax():
    aff = tcluster.cosine_affinity(_clusters(3, 15, 16, 0.1, 3))
    p_list = [2, 5, 9, 11]
    jg, je = jcluster._batched_eig_sweep(aff, p_list, 8)
    tg, te = tcluster._batched_eig_sweep(aff, p_list, 8)
    np.testing.assert_array_equal(te, je)
    assert int(np.argmin(tg)) == int(np.argmin(jg))


def test_nmesc_matches_jax_on_port_embeddings(ckpt):
    """Eight embeddings of the port's TitaNet (two tones, four windows
    each, full and ragged lengths), L2-normalised as the pipeline does."""
    embs = []
    for seed, freq in ((10, 220.0), (20, 1400.0)):
        w = np.stack([make_audio(taudio.SPK_WINDOW_SAMPLES, seed + i, freq)
                      for i in range(4)])
        lens = np.asarray([24000, 20000, 24000, 12000], np.int32)
        for i, ln in enumerate(lens):
            w[i, ln:] = 0.0
        e = tnets.spk_embed(ckpt["port"].spk, torch.from_numpy(w),
                            torch.from_numpy(lens)).numpy()
        embs.append(e / (np.sqrt((e ** 2).sum(axis=1, keepdims=True))
                         + 1e-8))
    emb = np.concatenate(embs)
    for kw in ({}, {"oracle_num_speakers": 2}):
        want = jcluster.nmesc_cluster(emb, jcluster.NmescConfig(
            min_samples_for_nmesc=4, **kw))
        got = tcluster.nmesc_cluster(emb, tcluster.NmescConfig(
            min_samples_for_nmesc=4, **kw))
        assert got.est_num_speakers == want.est_num_speakers
        np.testing.assert_array_equal(got.labels, want.labels)


def _vad_fn(wins, lens):
    rms = np.sqrt((wins ** 2).mean(axis=1))
    return (rms > 0.05).astype(np.float32) * 0.99


def _spk_fn(wins, lens):
    spec = np.abs(np.fft.rfft(wins, axis=1))[:, :192]
    return spec / (np.linalg.norm(spec, axis=1, keepdims=True) + 1e-8)


def two_speaker_audio():
    """5 s of one tone, 1 s of silence, 5 s of another."""
    return np.concatenate([make_audio(5 * 16000, 5, 200.0),
                           np.zeros(16000, np.float32),
                           make_audio(5 * 16000, 6, 1200.0)])


def _run(mod, audio, chunk, words, **kw):
    """A pipeline of either package fed `audio` in pushes of `chunk` and
    `words` [(text, at_sec, conf)]; returns everything it produced."""
    p = mod.DiarizePipeline(**kw)
    pushed, lines = [], []
    for off in range(0, len(audio), chunk):
        pushed.append(p.push_audio(audio[off:off + chunk]))
        for text, at, conf in words:
            if off / 16000.0 <= at < (off + chunk) / 16000.0:
                p.push_text(text, at, conf=conf)
        lines += p.drain_json()
    res = p.finalize()
    lines += p.drain_json()
    return {
        "pushed": pushed, "segments": list(p.segments), "subs": list(p.subs),
        "embs": np.asarray(p.embs), "lines": lines,
        "words": [(w.text, w.at_sec, w.speaker, w.conf) for w in res.words],
        "timeline": [(s.start_sec, s.end_sec, s.speaker)
                     for s in res.timeline],
        "rttm": res.rttm, "speaker_text": res.speaker_text,
        "n_speakers": res.n_speakers,
        "speaker_at": [mod.speaker_at(res.timeline, t)
                       for t in np.arange(0.0, 12.0, 0.25)],
    }


WORDS = [(f"w{i} " if i % 3 else f"pa{i}", i + 0.5, 0.1 * (i % 7) - 0.05)
         for i in range(11)]


def test_pipeline_with_injected_nets_matches_jax():
    audio = two_speaker_audio()
    kw = dict(model_params=None, num_speakers=2, vad_fn=_vad_fn,
              spk_fn=_spk_fn)
    want = _run(jpipe, audio, 8000, WORDS, **kw)
    got = _run(tpipe, audio, 8000, WORDS, **kw)
    np.testing.assert_array_equal(got.pop("embs"), want.pop("embs"))
    assert got == want
    assert want["n_speakers"] == 2 and want["segments"]
    assert "SPEAKER session 1" in want["rttm"]
    assert any('"conf"' in line for line in want["lines"])
    probs = _vad_fn(np.lib.stride_tricks.sliding_window_view(
        audio, 10080)[::160], None)
    for kw in ({}, dict(onset=0.5, offset=0.5, min_duration_off=0.4,
                        pad_onset=0.05, pad_offset=0.1, min_duration_on=0.2)):
        assert [(s.start_sec, s.end_sec) for s in
                tpipe.vad_extract_segments(probs, **kw)] \
            == [(s.start_sec, s.end_sec) for s in
                jpipe.vad_extract_segments(probs, **kw)]


def test_pipeline_with_the_nets_matches_jax(ckpt):
    """3 s of a tone with noise, pushed at once (one VAD batch of 256
    windows, one speaker batch): segments and sub-segments equal, the
    embeddings within the embedding rule, the outputs equal."""
    rng = np.random.default_rng(9)
    audio = make_audio(48000, 9, 260.0)
    audio[30000:34000] = 0.01 * rng.standard_normal(4000)
    words = [("hello ", 0.4, -1.0), ("wor", 1.1, -1.0), ("ld ", 1.3, -1.0),
             ("again ", 2.6, -1.0)]
    want = _run(jpipe, audio, len(audio), words,
                model_params=ckpt["jax"], num_speakers=-1)
    got = _run(tpipe, audio, len(audio), words,
               model_params=ckpt["port"], num_speakers=-1)
    je, te = want.pop("embs"), got.pop("embs")
    assert te.shape == je.shape and len(je) >= 1
    assert np.abs(te - je).max() < 5e-4  # L2-normalised rows
    assert got == want
    assert want["segments"] and want["rttm"]
    assert [json.loads(x)["word"] for x in want["lines"]] \
        == ["hello", "world", "again"]
