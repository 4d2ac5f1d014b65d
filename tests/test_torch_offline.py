"""The port's offline path against the JAX package's, part by part, on the
same seeded inputs at the tiny geometry (max_pos_len 64: a segment cap of
~500 mel frames): conv_subsampling with n_frames and the batch rel_pos_mha
with a key mask (atol 1e-4; the rel-shift exactly), encode_batch on a
ragged batch (atol 1e-4, each row's valid prefix within 1e-5 of its
exact-length run), transcribe_batch with a carried decoder state (tokens
equal), transcribe_mel / transcribe_audio / transcribe_audios (ids,
frames and text equal, with timestamps, across a segment boundary, and
with MEL_BUCKET patched to 64 in both packages), confidence=True (the
offline text unchanged). The tokens against tests/torch_oracle.py are
in test_torch_offline_oracle.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import rand, tiny_hparams

import nemotron_tpu.api as japi
from nemotron_tpu.audio.frontend import mel_full as j_mel_full
from nemotron_tpu.models import asr as jasr
from nemotron_tpu.models import decoder as jd
from nemotron_tpu.models import encoder as je
from nemotron_tpu.ops import conv as jc
from nemotron_tpu.ops import rel_attention as jra
from nemotron_tpu.params import random_params as j_random
import nemotron_tpu_torch.api as tapi
from nemotron_tpu_torch import kernels
from nemotron_tpu_torch.models import asr as tasr
from nemotron_tpu_torch.models import decoder as td
from nemotron_tpu_torch.models import encoder as te
from nemotron_tpu_torch.ops import conv as tc
from nemotron_tpu_torch.ops import rel_attention as tra
from nemotron_tpu_torch.params import random_params as t_random

torch.set_num_threads(1)
ATOL = 1e-4
PREFIX_ATOL = 1e-5


def T(x):
    return torch.tensor(np.asarray(x))


def make_audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = (0.4 * np.sin(2 * np.pi * 300 * t) * (np.sin(2 * np.pi * 2 * t) > 0)
           + 0.25 * np.sin(2 * np.pi * 740 * t)
           + 0.15 * rng.standard_normal(n))
    return (np.clip(sig, -1, 1) * 30000).astype(np.int16)


@pytest.fixture(scope="module")
def params():
    hp = tiny_hparams()
    return hp, j_random(hp, seed=2), t_random(hp, seed=2, device="cpu")


@pytest.fixture(scope="module")
def models():
    hp = tiny_hparams()
    return hp, japi.ASRModel.random(hp, seed=1), \
        tapi.ASRModel.random(hp, seed=1, device="cpu")


def ragged_mel(hp, lengths, seed):
    mel = rand(len(lengths), max(lengths), hp.n_mels, seed=seed)
    for i, n in enumerate(lengths):
        mel[i, n:] = 0.0
    return mel


LENGTHS = [(83, 41, 64), (200, 9, 131)]


@pytest.mark.parametrize("lengths", LENGTHS)
def test_conv_subsampling_with_n_frames(params, lengths):
    hp, jp, tp = params
    mel = ragged_mel(hp, lengths, seed=4)
    n_mel = np.asarray(lengths, np.int32)
    want = jc.conv_subsampling(jp.subsampling, jnp.asarray(mel),
                               n_frames=jnp.asarray(n_mel))
    got = tc.conv_subsampling(tp.subsampling, T(mel), n_frames=T(n_mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for i, n in enumerate(lengths):  # each row's prefix = its exact run
        exact = tc.conv_subsampling(tp.subsampling, T(mel[i:i + 1, :n]))
        np.testing.assert_allclose(got[i, :exact.shape[1]].numpy(),
                                   exact[0].numpy(), atol=PREFIX_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("qlen, klen", [(5, 5), (3, 7), (40, 40), (33, 50)])
def test_rel_shift_gather_is_exact(qlen, klen):
    """Both JAX forms (the one-hot product at qlen <= 32, the pad-reshape
    trick past it) against the port's strided view, bit for bit."""
    raw = rand(2, 3, qlen, 2 * klen - 1, seed=qlen + klen)
    want = np.asarray(jra.rel_shift_gather(jnp.asarray(raw), klen))
    got = tra.rel_shift_gather(T(raw), klen)
    np.testing.assert_array_equal(got.numpy(), want)
    i, j = np.meshgrid(np.arange(qlen), np.arange(klen), indexing="ij")
    np.testing.assert_array_equal(want, raw[:, :, i, j + qlen - 1 - i])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t", [7, 40])
def test_rel_pos_mha_batch_matches(params, t, masked):
    hp, jp, tp = params
    x = rand(3, t, hp.d_model, seed=11)
    jl, tl = (je.pos_emb_slice(jp.pos_emb, 2 * t - 1),
              te.pos_emb_slice(tp.pos_emb, 2 * t - 1))
    mask = None
    if masked:
        n = np.array([t, t // 2, 1])
        mask = np.where(np.arange(t)[None, :] >= n[:, None], -1e9,
                        0.0).astype(np.float32)

    def weights(layers, i):
        return [getattr(layers, f)[i] for f in (
            "attn_q_w", "attn_k_w", "attn_v_w", "attn_pos_w", "attn_out_w",
            "pos_bias_u", "pos_bias_v")]

    want = jra.rel_pos_mha(jnp.asarray(x), jl, *weights(jp.layers, 1),
                           hp.n_heads, hp.d_head,
                           attn_mask=None if mask is None else
                           jnp.asarray(mask))
    got = tra.rel_pos_mha(T(x), tl, *weights(tp.layers, 1), hp.n_heads,
                          hp.d_head, None if mask is None else T(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("lengths", LENGTHS)
def test_encode_batch_ragged(params, lengths):
    hp, jp, tp = params
    mel = ragged_mel(hp, lengths, seed=5)
    n_mel = np.asarray(lengths, np.int32)
    n_sub = np.asarray([hp.subsampled_len(n) for n in lengths], np.int32)
    want = je.encode_batch(jp, hp, jnp.asarray(mel),
                           n_frames=jnp.asarray(n_sub),
                           n_mel_frames=jnp.asarray(n_mel))
    got = te.encode_batch(tp, hp, T(mel), n_frames=T(n_sub),
                          n_mel_frames=T(n_mel))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for i, n in enumerate(lengths):
        exact = te.encode_batch(tp, hp, T(mel[i:i + 1, :n]))
        assert exact.shape[1] == n_sub[i]
        np.testing.assert_allclose(got[i, :n_sub[i]].numpy(),
                                   exact[0].numpy(), atol=PREFIX_ATOL,
                                   rtol=0)


def test_encode_batch_with_prompt_fusion():
    hp = tiny_hparams(num_prompts=4)
    jp, tp = j_random(hp, seed=6), t_random(hp, seed=6, device="cpu")
    mel = ragged_mel(hp, (70, 50), seed=7)
    oh = np.eye(4, dtype=np.float32)[[2, 0]]
    want = je.encode_batch(jp, hp, jnp.asarray(mel), jnp.asarray(oh))
    got = te.encode_batch(tp, hp, T(mel), T(oh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_transcribe_batch_carries_the_decoder_state(params):
    """Two segments of a ragged batch (one stream ends in the first), the
    decoder state carried: tokens equal each time, the state within 5e-5;
    the decode's iteration count, in whole blocks, is reported."""
    hp, jp, tp = params
    jp.joint.out_b = jp.joint.out_b.at[hp.blank_id].add(-1.0)
    tp.joint.out_b[hp.blank_id] -= 1.0
    try:
        js = jd.init_decode_state(3, hp)
        ts = td.init_decode_state(3, hp, device="cpu")
        for seg, lengths in enumerate([(96, 40, 96), (57, 0, 30)]):
            mel = ragged_mel(hp, lengths, seed=20 + seg)
            n_mel = np.asarray(lengths, np.int32)
            n_sub = np.asarray([hp.subsampled_len(n) if n else 0
                                for n in lengths], np.int32)
            jt, js = jasr.transcribe_batch(
                jp, jnp.asarray(mel), hp=hp, n_frames=jnp.asarray(n_sub),
                dec_state=js, n_mel_frames=jnp.asarray(n_mel))
            stats = {}
            tt, ts = tasr.transcribe_batch(
                tp, T(mel), hp=hp, n_frames=T(n_sub), dec_state=ts,
                n_mel_frames=T(n_mel), stats=stats)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            assert (tt.numpy() >= 0).sum() > 5
            # whole blocks, up to DECODE_EXIT_EVERY - 1 past the bound
            assert max(n_sub) <= stats["iterations"] \
                < tt.shape[1] * 11 + 1 + tasr.DECODE_EXIT_EVERY
            assert stats["iterations"] % tasr.DECODE_EXIT_EVERY == 0
            for name in ("h", "c"):
                np.testing.assert_allclose(
                    getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                    atol=5e-5, rtol=0)
            for name in ("prev_token", "frame_offset"):
                np.testing.assert_array_equal(
                    getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    finally:
        jp.joint.out_b = jp.joint.out_b.at[hp.blank_id].add(1.0)
        tp.joint.out_b[hp.blank_id] += 1.0


def test_max_segment_matches(models):
    hp, jm, tm = models
    assert tm.max_seg_mel_frames == jm.max_seg_mel_frames
    assert hp.subsampled_len(tm.max_seg_mel_frames) <= hp.max_pos_len
    assert tapi.MEL_BUCKET == japi.MEL_BUCKET == 1024


@pytest.mark.parametrize("n", [9600, 96000])
def test_transcribe_mel_matches(models, n):
    """One file's mel: 9,600 samples, and 96,000 (past the segment cap of
    ~500 mel frames: two segments, the decoder state carried)."""
    hp, jm, tm = models
    audio = make_audio(n, seed=n % 97)
    mel = j_mel_full(audio, jm.params.preproc.filterbank,
                     jm.params.preproc.window)
    want = jm.transcribe_mel(mel)
    got = tm.transcribe_mel(mel)
    assert got == want
    assert len(want[0]) > 3
    assert len(tm.offline_stats) == (2 if mel.shape[0] > tm.max_seg_mel_frames
                                     else 1)


def test_transcribe_audio_and_audios_match(models):
    """transcribe_audio per file and transcribe_audios of three files (one
    past the segment cap) with timestamps: both equal the JAX package's
    texts, and the batch equals the files one by one; the batch's mel is
    one frontend call."""
    hp, jm, tm = models
    audios = [make_audio(7000, 21), make_audio(96000, 22),
              make_audio(12800, 23)]
    want = [jm.transcribe_audio(a, timestamp_words=True) for a in audios]
    got = [tm.transcribe_audio(a, timestamp_words=True) for a in audios]
    assert got == want
    assert all("{" in w for w in want)
    assert tm.transcribe_audios(audios, timestamp_words=True) == want
    assert jm.transcribe_audios(audios) == tm.transcribe_audios(audios)
    before = kernels.MEL_FRAMES.launches  # CPU tensors: counted nowhere
    assert tm.transcribe_audios([]) == []
    assert kernels.MEL_FRAMES.launches == before == 0


def test_bucketing_invariance(models, monkeypatch):
    """MEL_BUCKET 64 in both packages: other paddings, the same tokens."""
    hp, jm, tm = models
    audio = make_audio(7000, seed=15)
    mel = j_mel_full(audio, jm.params.preproc.filterbank,
                     jm.params.preproc.window)
    ids = tm.transcribe_mel(mel)
    monkeypatch.setattr(japi, "MEL_BUCKET", 64)
    monkeypatch.setattr(tapi, "MEL_BUCKET", 64)
    got = tm.transcribe_mel(mel)
    assert got == ids == jm.transcribe_mel(mel)
    assert tm.offline_stats[0]["mel_frames"] == 64 * -(-mel.shape[0] // 64)


def test_confidence_leaves_the_offline_text_unchanged(models, monkeypatch):
    hp, jm, tm = models
    audio = make_audio(19200, seed=4)
    want = tm.transcribe_audio(audio)
    conf = tapi.ASRModel(hp, tm.params, tm.tokenizer.vocab, device="cpu",
                         confidence=True)
    assert conf.transcribe_audio(audio) == want
    assert conf.transcribe_audios([audio, audio]) == [want, want]
    monkeypatch.setenv("NEMOTRON_TPU_CONFIDENCE", "1")
    assert japi.ASRModel.random(hp, seed=1).transcribe_audio(audio) == want
