"""Right contexts 1, 6 and 13 (chunk_len 2, 7 and 14 encoder frames; 25 / 65
/ 121 mel frames per chunk) in the port against the JAX package, at the
tiny geometry (tests/helpers.tiny_hparams: att_left_context 8, so at R=13
a chunk is longer than the attention window).

Per module: the phase constants against the JAX package's one-hot at
T > 1, `rel_pos_mha_fullbuf` at T in {2, 7, 14} over dense and int8 caches
(f32 atol 1e-5; bf16 within 4 bf16 ulps of the output's largest
magnitude), the depthwise causal conv at T > K - 1 and the conv
subsampling at the modes' chunk widths (atol 5e-5, as tests/test_torch_ops.py).

The slice as a whole: the fused tick of both packages in lockstep
(tests/test_torch_tick.py:Lockstep) at each mode's own n_phases (8 / 4 /
2), in short segments from a fresh state: the slack-buffer wrap, one
k = n_phases chunk-loop tick, masked ticks with realign on resume
(positive delta), a masked wrap compaction with realign on resume
(negative delta), and a finalize with a zero-padded partial block and a
reduced n_valid. Tokens exactly equal, state within 1e-4 (int8 codes +-1;
bf16: the encoder leaves within 2^-5 of each leaf's largest magnitude).
The int8 K/V and bf16 runs are in tests/test_torch_right_context_int8.py,
the Q8_0 runs in tests/test_torch_right_context_q8.py, the engine and the
server in tests/test_torch_right_context_serving.py, the CLI in
tests/test_torch_cli.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import rand, tiny_hparams
from test_torch_tick import Lockstep, assert_states_close, make_audio

from nemotron_tpu.models.encoder import _phase_attn_constants as j_consts
from nemotron_tpu.ops import conv as jc
from nemotron_tpu.ops import kvquant as jkv
from nemotron_tpu.ops.rel_attention import rel_pos_mha_fullbuf as j_mha
from nemotron_tpu.params import random_params as j_random
from nemotron_tpu_torch.config import CacheConfig
from nemotron_tpu_torch.models.encoder import _phase_attn_constants as t_consts
from nemotron_tpu_torch.ops import conv as tc
from nemotron_tpu_torch.ops import kvquant as tkv
from nemotron_tpu_torch.ops import mel_kernel as mk
from nemotron_tpu_torch.ops.rel_attention import rel_pos_mha_fullbuf as t_mha
from nemotron_tpu_torch.params import random_params as t_random
from nemotron_tpu_torch.streaming.engine import (PRIME_SAMPLES,
                                                 max_safe_tick_chunks)

torch.set_num_threads(1)

MODES = (1, 6, 13)
BF16_REL = 2.0 ** -5


def mode_geometry(mode):
    """(chunk_len, n_phases, S_buf) of a mode at the tiny geometry."""
    hp = tiny_hparams()
    cfg = CacheConfig.for_mode(mode, hp)
    return cfg.chunk_len(hp), cfg.n_phases, cfg.cache_buf_len(hp)


def test_mode_geometry():
    hp = tiny_hparams()
    got = {m: (CacheConfig.for_mode(m, hp).chunk_mel_frames,
               CacheConfig.for_mode(m, hp).shift_mel_frames,
               *mode_geometry(m)) for m in MODES}
    assert got == {1: (25, 16, 2, 8, 24), 6: (65, 56, 7, 4, 36),
                   13: (121, 112, 14, 2, 36)}


# --- per module --------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_phase_constants_match_jax_one_hot(mode):
    T, n, s_buf = mode_geometry(mode)
    lc = tiny_hparams().att_left_context
    for phase in range(n + 1):  # n: the window at the wrap
        jj, onehot = j_consts(lc, T, s_buf, phase)
        tj, pos_index = t_consts(lc, T, s_buf, phase)
        np.testing.assert_array_equal(tj, jj)
        assert pos_index.shape == (T, s_buf + T)
        live = pos_index >= 0
        np.testing.assert_array_equal(live, onehot.sum(1) > 0)
        np.testing.assert_array_equal(
            pos_index[live], onehot.argmax(1)[live])


def mha_inputs(mode, phase, int8, seed):
    """Inputs of one layer's attention at the mode's chunk and buffer."""
    T, _, s_buf = mode_geometry(mode)
    lc = tiny_hparams().att_left_context
    rng = np.random.default_rng(seed)
    B, H, Dh = 3, 4, 16
    D = H * Dh
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    x, pe = r(B, T, D), r(2 * (lc + T) - 1, D)
    ws = [r(D, D, sc=D ** -0.5) for _ in range(5)]
    bu, bv = r(H, Dh, sc=0.1), r(H, Dh, sc=0.1)
    kb, vb = r(B, H, s_buf, Dh), r(B, H, s_buf, Dh)
    valid = np.array([lc, 3, 0])  # full window, partial, no history
    jj, onehot = j_consts(lc, T, s_buf, phase)
    mask = np.where(jj[None, :] < (lc - valid)[:, None], -1e9, 0.0
                    ).astype(np.float32)
    _, pos_index = t_consts(lc, T, s_buf, phase)
    if int8:
        kb, vb = tkv.quantize_kv(torch.tensor(kb)), tkv.quantize_kv(
            torch.tensor(vb))
    return dict(x=x, pe=pe, ws=ws, bu=bu, bv=bv, kb=kb, vb=vb, H=H, Dh=Dh,
                onehot=onehot, mask=mask, pos_index=pos_index)


def run_both(a, jdtype=jnp.float32, tdtype=torch.float32):
    """rel_pos_mha_fullbuf of both packages on the inputs `a`."""

    def jbuf(b):
        if isinstance(b, tkv.QuantKV):
            return jkv.QuantKV(jnp.asarray(b.q.numpy()),
                               jnp.asarray(b.s.numpy()))
        return jnp.asarray(b, dtype=jdtype)

    def tbuf(b):
        return b if isinstance(b, tkv.QuantKV) else torch.tensor(b).to(tdtype)

    J = lambda v: jnp.asarray(v, dtype=jdtype)  # noqa: E731
    Tt = lambda v: torch.tensor(v).to(tdtype)  # noqa: E731
    want = j_mha(J(a["x"]), J(a["pe"]), *map(J, a["ws"]), J(a["bu"]),
                 J(a["bv"]), a["H"], a["Dh"], jbuf(a["kb"]), jbuf(a["vb"]),
                 J(a["onehot"]), J(a["mask"]))
    got = t_mha(Tt(a["x"]), Tt(a["pe"]), *map(Tt, a["ws"]), Tt(a["bu"]),
                Tt(a["bv"]), a["H"], a["Dh"], tbuf(a["kb"]), tbuf(a["vb"]),
                torch.tensor(a["pos_index"]), Tt(a["mask"]))
    return ([g.float().numpy() for g in got],
            [np.asarray(w.astype(jnp.float32)) for w in want])


@pytest.mark.parametrize("cache", ["dense", "int8"])
@pytest.mark.parametrize("mode", MODES)
def test_rel_pos_mha_fullbuf_matches_jax(mode, cache):
    T, n, _ = mode_geometry(mode)
    for phase in (0, n - 1):
        a = mha_inputs(mode, phase, cache == "int8", seed=mode + phase)
        got, want = run_both(a)
        assert got[0].shape == (3, T, 64) and got[1].shape == (3, 4, T, 16)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                       err_msg=f"phase {phase}")


@pytest.mark.parametrize("cache", ["dense", "int8"])
def test_rel_pos_mha_fullbuf_bf16_within_bound(cache):
    """T=14 in bf16: scale and softmax in bf16 in both packages."""
    a = mha_inputs(13, 1, cache == "int8", seed=40)
    got, want = run_both(a, jnp.bfloat16, torch.bfloat16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=BF16_REL * np.abs(w).max())


def test_dead_slots_weigh_exactly_zero_at_t_gt_1():
    """Garbage in the dead slots of an int8 cache changes nothing."""
    a = mha_inputs(13, 1, True, seed=41)
    got, _ = run_both(a)
    lc = tiny_hparams().att_left_context
    dead = torch.tensor(a["mask"][:, :a["kb"].s.shape[-1]] < 0)[:, None]
    for buf in (a["kb"], a["vb"]):
        buf.q.masked_fill_(dead[..., None], 127)
        buf.s.masked_fill_(dead, 3.0e4)
    x = torch.tensor(a["x"])
    again = t_mha(x, torch.tensor(a["pe"]), *map(torch.tensor, a["ws"]),
                  torch.tensor(a["bu"]), torch.tensor(a["bv"]), a["H"],
                  a["Dh"], a["kb"], a["vb"], torch.tensor(a["pos_index"]),
                  torch.tensor(a["mask"]))
    assert dead.sum() > lc  # stream 2 has no history at all
    np.testing.assert_array_equal(again[0].numpy(), got[0])


@pytest.mark.parametrize("t", [2, 7, 14])
@pytest.mark.parametrize("k", [5, 9])
def test_depthwise_causal_conv1d_beyond_kernel(t, k):
    """T > K - 1 at K=9 (full width) for T=14, and K=5 (tiny) for T >= 7:
    the new cache is the last K-1 frames of the chunk alone."""
    D = 32
    x, w, cache = rand(2, t, D, seed=t), rand(k, D, seed=k), rand(
        2, k - 1, D, seed=t + k)
    jy, jcache = jc.depthwise_causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(cache))
    ty, tcache = tc.depthwise_causal_conv1d(torch.tensor(x), torch.tensor(w),
                                            torch.tensor(cache))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=5e-5, rtol=0)
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache), atol=0,
                               rtol=0)
    if t >= k - 1:
        np.testing.assert_array_equal(tcache.numpy(), x[:, t - k + 1:])


@pytest.mark.parametrize("mode", MODES)
def test_conv_subsampling_at_chunk_width(mode):
    hp = tiny_hparams()
    cfg = CacheConfig.for_mode(mode, hp)
    T = cfg.chunk_len(hp)
    jp, tp = j_random(hp, seed=2), t_random(hp, seed=2, device="cpu")
    mel = rand(3, cfg.chunk_mel_frames, hp.n_mels, seed=mode)
    want = jc.conv_subsampling(jp.subsampling, jnp.asarray(mel))
    got = tc.conv_subsampling(tp.subsampling, torch.tensor(mel))
    assert tuple(got.shape) == want.shape \
        == (3, T + cfg.drop_extra_pre_encoded, hp.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=0)


@pytest.mark.parametrize("b", [256, 3, 1])
def test_mel_plan_at_right_context_frames(b):
    """Kernel B2's tile at the frames of a tick at right context 1 / 6 /
    13 (16 / 56 / 112 per stream): a tile of FRAME_TILES that fits 256
    threads; 16 frames with a dense filterbank, and with a slaney one
    whole 16-frame tiles where the streams fill the SMs."""
    for mode in MODES:
        f = CacheConfig.for_mode(mode).shift_mel_frames
        for wide in (False, True):
            tile = mk.mel_plan(b, f, wide, 132)
            assert tile in mk.FRAME_TILES and 16 * tile <= 256
            if wide or b == 256:
                assert tile == 16, (b, f, wide)


# --- the fused tick in lockstep ----------------------------------------

def _wrap(run):
    """From phase n_phases - 2: two ticks to the wrap compaction."""
    run.tick()
    run.tick()
    assert run.phase == 0


def _k(run):
    """From phase 0: one k = n_phases chunk-loop tick, its wrap inside."""
    k = max_safe_tick_chunks(run.cfg.n_phases)
    assert k == run.cfg.n_phases
    run.tick(k=k)
    assert run.phase == 0


def _pause(run):
    """Ticks a stream stays paused without a wrap in between."""
    return min(2, run.cfg.n_phases - 1)


def _masked_realign(run):
    """From phase 0: stream 1 paused, then realign +pause on resume."""
    paused = np.array([True, False, True])
    for _ in range(_pause(run)):
        run.tick(active=paused)
    assert run.phase - run.slot_phase[1] == _pause(run)
    run.tick(active=np.ones(3, bool))


def _masked_wrap(run):
    """From phase n_phases - pause: stream 2 paused through a masked wrap
    compaction, then realign -(n_phases - pause) on resume."""
    start = run.phase
    paused = np.array([True, True, False])
    for _ in range(_pause(run)):
        run.tick(active=paused)
    assert run.phase == 0 and run.slot_phase[2] == start
    run.tick(active=np.ones(3, bool))
    assert run.slot_phase[2] == 1


def _finalize(run):
    """From phase 0: a tick, then stream 0 finalizes with a zero-padded
    partial block and a reduced n_valid, stream 1 decodes n_valid 0,
    stream 2 is idle. No token lies past stream 0's n_valid."""
    run.tick()
    partial = run.cfg.shift_samples // 2 + 320
    nv = partial // run.cfg.hop_length // run.cfg.subsampling_factor
    assert 1 <= nv < run.cfg.valid_out_len
    run.tick(active=np.array([True, True, False]),
             n_valid=np.array([nv, 0, 0]), partial={0: partial})
    assert (run.tokens[0, nv:] < 0).all() and (run.tokens[1:] < 0).all()


SEGMENTS = {"wrap": _wrap, "k": _k, "masked_realign": _masked_realign,
            "masked_wrap": _masked_wrap, "finalize": _finalize}


def start_phase(name, n_phases):
    if name == "wrap":
        return n_phases - 2
    if name == "masked_wrap":
        return n_phases - min(2, n_phases - 1)
    return 0


def run_segment(mode, name, check=assert_states_close, **kw):
    """One segment at `mode` from a fresh lockstep state, its end state held
    by `check`; returns the run."""
    _, n, _ = mode_geometry(mode)
    cfg = CacheConfig.for_mode(mode, tiny_hparams())
    run = Lockstep(make_audio(PRIME_SAMPLES + (n + 3) * cfg.shift_samples,
                              seed=5), phase=start_phase(name, n), mode=mode,
                   **kw)
    SEGMENTS[name](run)
    check(run.js, run.ts, f"R={mode} after {name}", run.bf16)
    assert any(run.ids), run.ids
    return run


@pytest.mark.parametrize("name", list(SEGMENTS))
@pytest.mark.parametrize("mode", MODES)
def test_fused_tick_matches_jax(mode, name):
    run_segment(mode, name)
