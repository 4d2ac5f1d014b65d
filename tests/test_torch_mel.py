"""The port's mel frontend against the JAX package's: mel_step (carries
included) against ops/mel.mel_step, and mel_frames_ref against the Pallas
mel kernel in interpret mode. 1e-3 absolute on log-mel, the JAX suite's own
bound between its two mel paths (tests/test_mel_pallas.py:37)."""

import jax.numpy as jnp
import numpy as np
import torch

from nemotron_tpu.ops import mel as jmel
from nemotron_tpu.ops.mel_pallas import _pad_fb, mel_frames_pallas
from nemotron_tpu_torch.ops import mel as tmel
from nemotron_tpu_torch.ops.mel_kernel import mel_frames, mel_frames_ref

torch.set_num_threads(1)
ATOL = 1e-3


def inputs(seed, B=16, n_frames=8):
    rng = np.random.default_rng(seed)
    n_buf = (n_frames - 1) * 160 + 512
    buf = (rng.standard_normal((B, n_buf)) * 0.1).astype(np.float32)
    fb = rng.uniform(0, 1, (128, 257)).astype(np.float32)
    window = np.hanning(400).astype(np.float32)
    return buf, fb, window


def test_tables_window_and_framing_match():
    for a, b in zip(tmel.dft_bases(), jmel.dft_bases()):
        np.testing.assert_array_equal(a, b)
    w = np.hanning(400).astype(np.float32)
    np.testing.assert_array_equal(tmel.padded_window(torch.tensor(w)).numpy(),
                                  np.asarray(jmel.padded_window(w)))
    buf, _, _ = inputs(0, B=2)
    np.testing.assert_array_equal(
        tmel.frame_signal(torch.tensor(buf), 8).numpy(),
        np.asarray(jmel.frame_signal(jnp.asarray(buf), 8)))


def test_mel_frames_ref_matches_pallas_kernel_interpret():
    buf, fb, window = inputs(1)
    win512 = jmel.padded_window(window)
    want = np.asarray(mel_frames_pallas(
        jnp.asarray(buf), win512[None, :], jnp.asarray(_pad_fb(fb).T),
        n_frames=8, interpret=True))
    tw = tmel.padded_window(torch.tensor(window))
    got = mel_frames_ref(torch.tensor(buf), tw, torch.tensor(fb), 8).numpy()
    assert got.shape == want.shape == (16, 8, 128)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # on a CPU tensor the wrapper takes the plain version
    np.testing.assert_array_equal(
        mel_frames(torch.tensor(buf), tw, torch.tensor(fb), 8).numpy(), got)


def test_mel_step_matches_jax_with_carries():
    rng = np.random.default_rng(2)
    B, n_frames, tail_len = 4, 8, 352
    _, fb, window = inputs(2)
    tail = rng.uniform(-0.3, 0.3, (B, tail_len)).astype(np.float32)
    last = rng.uniform(-0.3, 0.3, B).astype(np.float32)
    jtail, jlast = jnp.asarray(tail), jnp.asarray(last)
    ttail, tlast = torch.tensor(tail), torch.tensor(last)
    jw, tw = jmel.padded_window(window), tmel.padded_window(torch.tensor(window))
    for step in range(3):  # the carries feed the next step
        audio = rng.uniform(-0.5, 0.5, (B, n_frames * 160)).astype(np.float32)
        jm, jtail, jlast = jmel.mel_step(jnp.asarray(audio), jtail, jlast, jw,
                                         jnp.asarray(fb), n_frames=n_frames)
        tm, ttail, tlast = tmel.mel_step(torch.tensor(audio), ttail, tlast, tw,
                                         torch.tensor(fb), n_frames=n_frames)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL,
                                   rtol=0, err_msg=f"step {step}")
        assert ttail.shape == (B, tail_len)
        np.testing.assert_allclose(ttail.numpy(), np.asarray(jtail),
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))


def test_preemphasis_matches():
    rng = np.random.default_rng(3)
    audio = rng.uniform(-1, 1, (3, 50)).astype(np.float32)
    last = rng.uniform(-1, 1, 3).astype(np.float32)
    np.testing.assert_allclose(
        tmel.preemphasis(torch.tensor(audio), torch.tensor(last)).numpy(),
        np.asarray(jmel.preemphasis(jnp.asarray(audio), jnp.asarray(last))),
        atol=1e-7, rtol=0)
