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
from nemotron_tpu_torch.ops import mel_kernel as mk
from nemotron_tpu_torch.ops.mel_kernel import mel_frames, mel_frames_ref
from nemotron_tpu_torch.tools.gemm_turns import slaney_filterbank
from test_reference_fixtures import slaney_mel_fb

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


# ---- kernel B2's host side: plan, filterbank layout, twiddles -------------

def test_mel_plan_by_shape_is_computed_once():
    """Narrow bands (slaney): whole-stream tiles at the tick's B=256 x 8,
    tiles of 16 that fill 132 SMs for a 60 s utterance, the smallest tile
    where few streams would leave SMs idle. Wide bands (dense): 16 frames'
    threads for the filterbank product at every shape. Each plan fits 256
    threads and is computed once per shape."""
    mk.mel_plan.cache_clear()
    want = {(256, 8): 8, (32, 8): 4, (1, 8): 4, (1, 6000): 16, (8, 24): 4,
            (1, 1): 4, (64, 40): 16, (32, 40): 8}
    for (b, f), tile in want.items():
        assert mk.mel_plan(b, f, False, 132) == tile, (b, f)
        assert mk.mel_plan(b, f, True, 132) == 16, (b, f)
        assert tile in mk.FRAME_TILES and 16 * tile <= 256
    for (b, f), tile in want.items():
        mk.mel_plan(b, f, False, 132)
    info = mk.mel_plan.cache_info()
    assert (info.misses, info.hits) == (2 * len(want), len(want))


def test_wide_bands_tell_dense_from_slaney():
    _, fb, _ = inputs(4)
    assert mk.wide_bands(mk.filterbank_layout(torch.tensor(fb)))
    for n_mels in (32, 80, 128):
        assert not mk.wide_bands(
            mk.filterbank_layout(torch.tensor(_slaney(n_mels))))


def _slaney(n_mels):
    return slaney_filterbank(n_mels)


def test_slaney_filterbank_matches_the_reference_fixture():
    """The numpy slaney filterbank the GPU tests, chip_smoke.py and
    tools/gemm_turns.py use equals the JAX suite's librosa one."""
    for n_mels in (32, 80, 128):
        np.testing.assert_array_equal(slaney_filterbank(n_mels),
                                      slaney_mel_fb(n_mels=n_mels))


def _unpack(lay, n_mels):
    """The filterbank [n_mels, 257] the kernel reads from a layout."""
    w, bands = lay.weights.numpy(), lay.bands.numpy()
    fb = np.zeros((n_mels, 257), np.float32)
    for m, (lo, hi, base, _) in enumerate(bands):
        fb[m, lo:hi] = w[base + lo:base + hi]
    return fb


def test_filterbank_layout_dense_bands_are_full():
    _, fb, _ = inputs(4)
    lay = mk.filterbank_layout(torch.tensor(fb))
    assert lay.bands.dtype == torch.int32
    assert lay.weights.dtype == torch.float32
    np.testing.assert_array_equal(
        lay.bands.numpy(),
        np.stack([np.zeros(128), np.full(128, 257), 257 * np.arange(128),
                  np.zeros(128)], axis=1))
    np.testing.assert_array_equal(lay.weights.numpy(), fb.reshape(-1))
    np.testing.assert_array_equal(_unpack(lay, 128), fb)


def test_filterbank_layout_slaney_bands_are_its_nonzero_runs():
    for n_mels in (32, 80, 128):
        fb = _slaney(n_mels)
        fb[n_mels // 2] = 0  # a zero row gets an empty band
        lay = mk.filterbank_layout(torch.tensor(fb))
        bands = lay.bands.numpy()
        for m, (lo, hi, _, _) in enumerate(bands):
            nz = np.flatnonzero(fb[m])
            if nz.size == 0:
                assert lo == hi
                continue
            # one run: every non-zero bin inside [lo, hi), its ends non-zero
            assert (lo, hi) == (nz[0], nz[-1] + 1)
            assert np.all(fb[m, lo:hi] > 0), m
        # only the bands are kept, packed (the kernel's bulk copy: 16 B)
        widths = bands[:, 1] - bands[:, 0]
        assert lay.weights.numel() == -(-widths.sum() // 4) * 4
        assert widths.max() < 257 // 4  # triangles, not full rows
        np.testing.assert_array_equal(_unpack(lay, n_mels), fb)


def test_filterbank_layout_follows_the_tensor():
    """Memoized on the tensor object and its version counter: the same
    tensor reuses its layout, a change in place or a new tensor gets a new
    one."""
    fb = torch.tensor(_slaney(128))
    lay = mk.filterbank_layout(fb)
    assert mk.filterbank_layout(fb) is lay
    fb[5, :] = 1.0  # in place: version moves
    lay2 = mk.filterbank_layout(fb)
    assert lay2 is not lay
    np.testing.assert_array_equal(lay2.bands.numpy()[5, :2], [0, 257])
    np.testing.assert_array_equal(_unpack(lay2, 128), fb.numpy())
    other = fb.clone()
    assert mk.filterbank_layout(other) is not lay2
    np.testing.assert_array_equal(mk.filterbank_layout(other).bands.numpy(),
                                  lay2.bands.numpy())


def test_twiddle_table_matches_float64():
    """Rows k1 * 16 + j: W256^(j k1); rows 256 + k: W512^k, k <= 256; in
    float64, each within float64 rounding of the exact value."""
    t = mk.twiddle_table()
    assert t.shape == (mk.TWIDDLES, 2) and t.dtype == np.float64
    k1, jj = np.divmod(np.arange(256), 16)
    ang = np.concatenate([-2 * np.pi * (k1 * jj) / 256,
                          -2 * np.pi * np.arange(257) / 512])
    np.testing.assert_allclose(t[:, 0], np.cos(ang), rtol=0, atol=4e-16)
    np.testing.assert_allclose(t[:, 1], np.sin(ang), rtol=0, atol=4e-16)
    np.testing.assert_allclose(t[:256].reshape(16, 16, 2)[3, 5],
                               [np.cos(2 * np.pi * 15 / 256),
                                -np.sin(2 * np.pi * 15 / 256)], atol=4e-16)


def _fft4(a0, a1, a2, a3):
    t0, t1, t2, t3 = a0 + a2, a0 - a2, a1 + a3, a1 - a3
    return t0 + t2, t1 - 1j * t3, t0 - t2, t1 + 1j * t3


def _fft16(v):
    """csrc/mel_frames.cu fft16: radix 4 x 4 with W16^(m1 k2), natural
    order out."""
    v = list(v)
    for m1 in range(4):
        v[m1], v[m1 + 4], v[m1 + 8], v[m1 + 12] = _fft4(*v[m1::4])
    for m1 in range(1, 4):
        for k2 in range(1, 4):
            v[m1 + 4 * k2] *= np.exp(-2j * np.pi * m1 * k2 / 16)
    for k2 in range(4):
        v[4 * k2:4 * k2 + 4] = _fft4(*v[4 * k2:4 * k2 + 4])
    return [v[4 * (k % 4) + k // 4] for k in range(16)]


def test_kernel_fft_schedule_matches_rfft():
    """The kernel's FFT as its threads run it, in numpy on its twiddle
    table: the 256-point complex FFT of even + i odd samples in two
    16-point steps with W256^(j k1) between them, then the split step that
    pairs lane j with lane (16 - j) % 16. Its power spectrum is the
    512-point rfft's within float64 rounding."""
    rng = np.random.default_rng(5)
    tw = mk.twiddle_table()
    tw = tw[:, 0] + 1j * tw[:, 1]
    for x in (rng.standard_normal(512), np.sin(np.arange(512) * 0.118)):
        z = x[0::2] + 1j * x[1::2]
        rows = np.zeros((16, 16), complex)  # [k1][j]: the exchange
        for j in range(16):
            a = _fft16(z[j::16])
            rows[:, j] = [a[k1] * tw[k1 * 16 + j] for k1 in range(16)]
        lanes = [_fft16(rows[k1]) for k1 in range(16)]  # Z[k1 + 16 k2]
        power = np.zeros(257)
        for j in range(16):
            partner = (16 - j) % 16
            for k2 in range(16):
                zc = lanes[partner][(16 - k2) % 16 if j == 0 else 15 - k2]
                zk, k = lanes[j][k2], j + 16 * k2
                e = (zk + np.conj(zc)) / 2
                o = (zk - np.conj(zc)) / 2j
                power[k] = abs(e + tw[256 + k] * o) ** 2
        power[256] = (lanes[0][0].real - lanes[0][0].imag) ** 2
        want = np.abs(np.fft.rfft(x)) ** 2
        np.testing.assert_allclose(power, want, rtol=0,
                                   atol=1e-12 * want.max())


def test_tick_frontend_constants_are_memoized():
    """The tick takes the padded window and the f32 filterbank once per
    params tensor: the same objects on every tick, new ones after a change
    in place."""
    w = torch.tensor(np.hanning(400).astype(np.float32))
    fb = torch.tensor(_slaney(128))
    w512 = tmel.window512_of(w)
    assert tmel.window512_of(w) is w512
    np.testing.assert_array_equal(w512.numpy(),
                                  tmel.padded_window(w).numpy())
    assert tmel.filterbank_f32(fb) is fb  # f32 already: no copy
    assert tmel.filterbank_f32(fb) is fb
    w.mul_(0.5)
    w512b = tmel.window512_of(w)
    assert w512b is not w512
    np.testing.assert_array_equal(w512b.numpy(), w512.numpy() * 0.5)
    half = fb.to(torch.float16)
    cast = tmel.filterbank_f32(half)
    assert cast.dtype == torch.float32 and tmel.filterbank_f32(half) is cast
