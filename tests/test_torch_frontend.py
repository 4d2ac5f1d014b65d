"""The port's host-side frontend (audio/frontend.py: StreamPreprocessor,
process_many, mel_full) against the JAX package's, over random piece sizes
and carried state; within 1e-4, as tests/test_frontend.py holds JAX against
its golden preprocessor (both compute f32 DFT-matmul mels)."""

import numpy as np
import torch

from nemotron_tpu.audio import frontend as jf
from nemotron_tpu_torch.audio import frontend as tf

torch.set_num_threads(1)
ATOL = 1e-4
WINDOW = np.hanning(400).astype(np.float32)


def make_audio(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)
    return (sig * 32767).astype(np.int16)


def make_fb(n_mels=32, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (n_mels, 257)).astype(
        np.float32)


def test_stream_preprocessor_matches_jax_over_random_pieces():
    fb = make_fb()
    audio = make_audio(12800, seed=2)
    jp, tp = jf.StreamPreprocessor(fb, WINDOW), tf.StreamPreprocessor(fb, WINDOW)
    rng = np.random.default_rng(3)
    i, n_frames = 0, 0
    while i < len(audio):
        n = int(rng.integers(1, 2000))
        want, got = jp.process(audio[i:i + n]), tp.process(audio[i:i + n])
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        np.testing.assert_array_equal(tp.buf, jp.buf)  # the carried samples
        assert tp.last_sample == jp.last_sample
        n_frames += got.shape[0]
        i += n
    assert n_frames >= 12800 // 160 - 4
    assert tp.process(np.zeros(0, np.int16)).shape == (0, 32)


def test_mel_full_and_frame_counts_match_jax():
    fb = make_fb(seed=4)
    audio = make_audio(8000, seed=5)
    np.testing.assert_allclose(tf.mel_full(audio, fb, WINDOW),
                               jf.mel_full(audio, fb, WINDOW), atol=ATOL,
                               rtol=0)
    pp = tf.StreamPreprocessor(fb, WINDOW)
    # 256 zeros of centre padding + 1280 samples -> 7 frames, then 8 a chunk
    assert pp.process(make_audio(1280)).shape[0] == 7
    for _ in range(3):
        assert pp.process(make_audio(1280, seed=6)).shape[0] == 8


def test_process_many_matches_jax_and_single_streams():
    fb = make_fb(seed=6)
    rng = np.random.default_rng(7)
    pps = {pkg: [pkg.StreamPreprocessor(fb, WINDOW) for _ in range(5)]
           for pkg in (jf, tf)}
    single = [tf.StreamPreprocessor(fb, WINDOW) for _ in range(5)]
    for rnd in range(3):  # carried state through the batched path
        audios = [make_audio(int(rng.integers(0, 6000)), seed=10 * rnd + i)
                  for i in range(5)]
        want = jf.process_many(pps[jf], audios)
        got = tf.process_many(pps[tf], audios)
        for i in range(5):
            assert got[i].shape == want[i].shape
            np.testing.assert_allclose(got[i], want[i], atol=ATOL, rtol=0)
            np.testing.assert_allclose(got[i], single[i].process(audios[i]),
                                       atol=1e-5, rtol=0)


def test_process_many_halves_match_jax_over_two_rounds():
    """process_many_start / process_many_finish, the same audio split into
    two rounds (the second round's start before the first round's finish
    is read, as a caller overlapping them does): JAX's mels, round by
    round; a round with no frame ready gives None in both."""
    fb = make_fb(seed=8)
    pps = {pkg: [pkg.StreamPreprocessor(fb, WINDOW) for _ in range(3)]
           for pkg in (jf, tf)}
    assert tf.process_many_start(pps[tf], [make_audio(100)] * 3) is None
    assert jf.process_many_start(pps[jf], [make_audio(100)] * 3) is None
    audios = [make_audio(n, seed=20 + i) for i, n in
              enumerate((7000, 3100, 5200))]
    cut = [2900, 1200, 4100]
    rounds = [[a[:c] for a, c in zip(audios, cut)],
              [a[c:] for a, c in zip(audios, cut)]]
    handles = {pkg: [pkg.process_many_start(pps[pkg], rnd)
                     for rnd in rounds] for pkg in (jf, tf)}
    for h_j, h_t in zip(handles[jf], handles[tf]):
        want, got = jf.process_many_finish(h_j), tf.process_many_finish(h_t)
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
