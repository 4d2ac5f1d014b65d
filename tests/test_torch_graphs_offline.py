"""The compiled offline path on the CPU (nemotron_tpu_torch/graphs.py,
models/asr.transcribe_batch, api.ASRModel._transcribe_mels): the bodies
that the card captures as CUDA graphs (the encoder per JAX key, the greedy
decode in blocks of DECODE_EXIT_EVERY iterations on a carry in fixed
storage, the diarize nets per bucket), run here eagerly through the same
bookkeeping.

- The block decode against the JAX package's jitted transcribe_batch
  (XLA's quantized linears, its default): a ragged batch of 3 whose bound
  T' x 11 + 1 is no multiple of 16, two segments with the decoder state
  carried, confidence=True, Q8_0 and Q4_0 encoder matrices (B4/B5's plain
  versions here). Tokens exact, the state within 5e-5 (f32), as
  tests/test_torch_offline.py holds them; the carry is the model's, longer
  than the segment, its frames past T' never read.
- No host sync: the encoder's body, the decode block's body and both
  diarize nets' bodies under test_torch_graphs.NoHostSync.
- The keys: a transcribe_audios call over a long file and a short one
  leaves the JAX model's `_fn_cache` ("batch", T, B) keys, and each
  segment's decode key at its own frames (the card's graphed decode keeps
  one carry, and so one key, for both: tests/test_torch_gpu.py).
- The bookkeeping: graphs=False equals the default on the CPU, neither
  keeps a decode carry, and drop_offline_graphs drops the offline keys
  alone.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import rand, tiny_hparams
from scripts_support import export_random_diarize_checkpoint
from test_torch_graphs import NoHostSync

from nemotron_tpu import params as jparams
from nemotron_tpu.api import ASRModel as JaxModel
from nemotron_tpu.models import asr as jasr
from nemotron_tpu.models import decoder as jd
from nemotron_tpu_torch import params as tparams
from nemotron_tpu_torch.api import ASRModel as TorchModel
from nemotron_tpu_torch.audio.frontend import process_many
from nemotron_tpu_torch.diarize import nets as tnets
from nemotron_tpu_torch.diarize.params import load_diarize_model
from nemotron_tpu_torch.graphs import GraphCache
from nemotron_tpu_torch.models import asr as tasr
from nemotron_tpu_torch.models import decoder as td

torch.set_num_threads(1)
STATE_ATOL = 5e-5
CPU = torch.device("cpu")


def T(x):
    return torch.tensor(np.asarray(x))


def ragged_mel(hp, lengths, seed):
    mel = rand(len(lengths), max(lengths), hp.n_mels, seed=seed)
    for i, n in enumerate(lengths):
        mel[i, n:] = 0.0
    return mel


def make_audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = (0.4 * np.sin(2 * np.pi * 300 * t) * (np.sin(2 * np.pi * 2 * t) > 0)
           + 0.25 * np.sin(2 * np.pi * 740 * t)
           + 0.15 * rng.standard_normal(n))
    return (np.clip(sig, -1, 1) * 30000).astype(np.int16)


def offline(model, audios):
    """The offline path over audios: ([(token ids, frames)] per file, the
    final decoder state)."""
    return model._transcribe_mels(process_many(
        [model._preprocessor() for _ in audios], audios), None)


def model_frames(hp):
    """The API's carry length: the longest segment's encoder frames."""
    return hp.subsampled_len(TorchModel.random(hp, device="cpu")
                             .max_seg_mel_frames)


# name -> (segments' mel lengths, confidence, quantized bits)
CASES = {"ragged": ([(88, 40, 77)], False, None),
         "segments": ([(96, 40, 96), (57, 0, 30)], False, None),
         "confidence": ([(88, 40, 77)], True, None),
         "q8": ([(88, 40, 77)], False, 8),
         "q4": ([(88, 40, 77)], False, 4)}


@pytest.mark.parametrize("name", list(CASES))
def test_block_decode_matches_jax_transcribe_batch(monkeypatch, name):
    segs, confidence, bits = CASES[name]
    hp = tiny_hparams()
    jp, tp = jparams.random_params(hp, seed=2), tparams.random_params(
        hp, seed=2, device="cpu")
    if bits:
        jp = jparams.quantize_encoder_layers(jp, bits=bits)
        tp = tparams.quantize_encoder_layers(tp, bits=bits)
    jp.joint.out_b = jp.joint.out_b.at[hp.blank_id].add(-1.0)
    tp.joint.out_b[hp.blank_id] -= 1.0
    monkeypatch.setenv("NEMOTRON_TPU_CONFIDENCE", "1" if confidence else "0")
    jfn = jax.jit(functools.partial(jasr.transcribe_batch, hp=hp))
    cache = GraphCache()
    carry = td.init_carry(3, model_frames(hp), hp, device="cpu")

    def run(key, body, state, inputs):
        return cache.run(key, 0, CPU, body, state, inputs, pool="offline")

    js = jd.init_decode_state(3, hp)
    ts = td.init_decode_state(3, hp, device="cpu")
    emitted = 0
    for seg, lengths in enumerate(segs):
        mel = ragged_mel(hp, lengths, seed=30 + seg)
        n_mel = np.asarray(lengths, np.int32)
        n_sub = np.asarray([hp.subsampled_len(n) if n else 0
                            for n in lengths], np.int32)
        t = hp.subsampled_len(mel.shape[1])
        if name == "ragged":  # the blocks cannot end on the bound
            assert (t * 11 + 1) % tasr.DECODE_EXIT_EVERY
        jt, js = jfn(jp, jnp.asarray(mel), n_frames=jnp.asarray(n_sub),
                     dec_state=js, n_mel_frames=jnp.asarray(n_mel))
        stats = {}
        tt, ts = tasr.transcribe_batch(
            tp, T(mel), hp=hp, n_frames=T(n_sub), dec_state=ts,
            n_mel_frames=T(n_mel), confidence=confidence, stats=stats,
            carry=carry, run=run)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        emitted += int((tt.numpy() >= 0).sum())
        assert stats["iterations"] % tasr.DECODE_EXIT_EVERY == 0
        assert max(n_sub) <= stats["iterations"] \
            < t * 11 + 1 + tasr.DECODE_EXIT_EVERY
        for f in ("h", "c"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       atol=STATE_ATOL, rtol=0)
        for f in ("prev_token", "frame_offset"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)))
    assert emitted > 5
    if confidence:  # packed values: some confidence above 0
        assert (np.asarray(jt) >= hp.vocab_size).any()
    assert cache.keys() == {("batch", max(lengths), 3) for lengths in segs} \
        | {("batch_decode", 3, model_frames(hp), confidence)}
    assert cache.stats()["captures"] == 0  # the CPU runs every body eagerly


# --- no host sync in the offline and diarize bodies ----------------------

def _offline_body(form):
    hp = tiny_hparams()
    tp = tparams.random_params(hp, seed=2, device="cpu")
    if form == "q8":
        tp = tparams.quantize_encoder_layers(tp, bits=8)
    lengths = (88, 40, 77)
    mel = T(ragged_mel(hp, lengths, seed=5))
    n_mel = T(np.asarray(lengths, np.int32))
    n_sub = T(np.asarray([hp.subsampled_len(n) for n in lengths], np.int32))
    carry = td.init_carry(3, model_frames(hp), hp, device="cpu")
    td.start_carry(carry, td.init_decode_state(3, hp, device="cpu"), n_sub)
    if form in ("f32", "q8"):
        return lambda: tasr.offline_encode(tp, carry, mel, n_sub, n_mel,
                                           hp=hp)
    tasr.offline_encode(tp, carry, mel, n_sub, n_mel, hp=hp)
    return lambda: td.decode_block(tp, hp, carry, tasr.DECODE_EXIT_EVERY,
                                   confidence=form == "block-confidence")


@pytest.fixture(scope="module")
def diarize_params(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("diarize") / "diarize.gguf")
    export_random_diarize_checkpoint(path, seed=7)
    return load_diarize_model(path, device="cpu")


SYNC_CASES = ["encode-f32", "encode-q8", "block", "block-confidence", "vad",
              "spk"]


@pytest.mark.parametrize("case", SYNC_CASES)
def test_offline_and_diarize_bodies_read_nothing_back(case, request):
    if case in ("vad", "spk"):
        p = request.getfixturevalue("diarize_params")
        net, n = ((tnets.vad_probs, 10080) if case == "vad"
                  else (tnets.spk_embed, 24000))
        w = torch.tensor(rand(2, n, seed=3) * 0.3)
        lens = torch.tensor(np.array([n, n * 2 // 3], np.int32))
        call = lambda: net(getattr(p, case), w, lens)  # noqa: E731
    else:
        call = _offline_body(case.removeprefix("encode-"))
    call()  # the warm-up (it fills the constants' caches)
    with NoHostSync() as mode:
        call()
    assert mode.ops > 50  # the body ran under the mode


# --- the bookkeeping ---------------------------------------------------

def test_offline_keys_equal_the_jax_fn_cache(monkeypatch):
    """A long file (two segments) beside a short one, MEL_BUCKET 64 in
    both packages: the port's ("batch", T, B) keys equal JAX's, one per
    segment, and each segment's counts name its encoder key, called once,
    and its decode key, at the segment's frames (the eager decode's carry
    is the segment's own), called once per block."""
    import nemotron_tpu.api as japi
    import nemotron_tpu_torch.api as tapi

    monkeypatch.setattr(japi, "MEL_BUCKET", 64)
    monkeypatch.setattr(tapi, "MEL_BUCKET", 64)
    hp = tiny_hparams()
    jm = JaxModel.random(hp, seed=1)
    tm = TorchModel.random(hp, seed=1, device="cpu")
    audios = [make_audio(96000, 22), make_audio(7000, 21)]
    assert tm.transcribe_audios(audios) == jm.transcribe_audios(audios)
    want = {k for k in jm._fn_cache if k[0] == "batch"}
    assert want == {("batch", tm.max_seg_mel_frames, 2), ("batch", 128, 2)}
    assert {k for k in tm.graphs.keys() if k[0] == "batch"} == want
    segs = tm.offline_stats
    assert len(segs) == 2
    decode = [("batch_decode", 2, hp.subsampled_len(s["mel_frames"]), False)
              for s in segs]
    assert tm.graphs.keys() - want == set(decode)
    for s, key in zip(segs, decode):
        blocks = s["iterations"] // tasr.DECODE_EXIT_EVERY
        assert s["graphs"] == {
            ("batch", s["mel_frames"], 2): {"calls": 1, "captures": 0,
                                            "replays": 0},
            key: {"calls": blocks, "captures": 0, "replays": 0}}


def test_graphs_off_equals_the_default_and_drop_keeps_the_ticks():
    """On the CPU both run the bodies eagerly: texts, token ids, the final
    decoder state and the stats (but their seconds) equal, and neither
    keeps a decode carry. drop_offline_graphs drops the offline keys
    alone: a tick's key stays."""
    hp = tiny_hparams()
    a = TorchModel.random(hp, seed=1, device="cpu")
    b = TorchModel(hp, a.params, a.tokenizer.vocab, device="cpu",
                   graphs=False)
    audios = [make_audio(96000, 5), make_audio(12800, 6)]
    assert a.transcribe_audios(audios) == b.transcribe_audios(audios)
    (ids_a, st_a), (ids_b, st_b) = offline(a, audios), offline(b, audios)
    assert ids_a == ids_b
    # the stats but the spans' seconds, which are times
    assert [{k: v for k, v in st.items() if not k.endswith("_seconds")}
            for st in a.offline_stats] == [
        {k: v for k, v in st.items() if not k.endswith("_seconds")}
        for st in b.offline_stats]
    for f in ("h", "c", "prev_token", "frame_offset"):
        assert torch.equal(getattr(st_a, f), getattr(st_b, f))
    assert a.graphs.stats() == b.graphs.stats()
    assert not a._carries and not b._carries
    cfg = a.cache_config(0)
    state = a.init_stream_state(2, cfg)
    a.fused_tick_packed(cfg, state, a.put_batch(a.pack_tick_inputs(
        np.zeros((2, cfg.shift_samples), np.int16), np.ones(2), np.zeros(2),
        None)), True)
    a.drop_offline_graphs()
    assert {k[0] for k in a.graphs.keys()} == {"tick_packed"}
    assert a.transcribe_audios(audios) == b.transcribe_audios(audios)
