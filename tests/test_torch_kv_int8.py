"""Int8 K/V caches in the port against the JAX package (NEMOTRON_TPU_KV_INT8=1
there, `kv_int8=True` here), at tiny size on the CPU, where kernel B1 takes
its plain version (the kernel is held against it on the card in
tests/test_torch_gpu.py).

Exact: quantize_kv's codes and scales, the zero state, reset_slots, and the
cache moves (masked and unmasked compaction, realign), which carry codes and
scales together. Within 1e-5 (f32 sums in another order): T=1 attention
over an int8 cache. Over the lockstep schedule segments of
tests/test_torch_tick.py with Q8_0 weights and int8 caches: tokens equal,
int8 codes within +-1 (a value on a rounding boundary may round either
way), every other leaf within 1e-4; in bf16, the rule of
tests/test_torch_tick_bf16.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_hparams
from test_torch_tick import SEGMENTS, run_segment

from nemotron_tpu.models import encoder as jenc
from nemotron_tpu.models.encoder import _phase_attn_constants as j_consts
from nemotron_tpu.ops import kvquant as jkv
from nemotron_tpu.ops.rel_attention import rel_pos_mha_fullbuf as j_mha
from nemotron_tpu.streaming import state as jstate
from nemotron_tpu_torch.models import encoder as tenc
from nemotron_tpu_torch.models.encoder import _phase_attn_constants as t_consts
from nemotron_tpu_torch.ops import kvquant as tkv
from nemotron_tpu_torch.ops.attn_kernel import (t1_attention_core,
                                                t1_attention_core_ref)
from nemotron_tpu_torch.ops.rel_attention import rel_pos_mha_fullbuf as t_mha
from nemotron_tpu_torch.shared.config import CacheConfig
from nemotron_tpu_torch.streaming import state as tstate

torch.set_num_threads(1)


def to_jax(buf):
    return jkv.QuantKV(q=jnp.asarray(buf.q.numpy()),
                       s=jnp.asarray(buf.s.numpy()))


def assert_same(jbuf, tbuf):
    for j, t in ((jbuf.q, tbuf.q), (jbuf.s, tbuf.s)):
        j, t = np.asarray(j), t.numpy()
        assert j.dtype == t.dtype and j.shape == t.shape
        np.testing.assert_array_equal(t, j)


def test_quantize_kv_equals_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    x[0, 1, 2] = 0.0                        # an all-zero frame: scale 0
    x[1, 0, 4] = np.arange(16) - 7.5        # halves at scale 7.5 / 127
    tbuf = tkv.quantize_kv(torch.tensor(x))
    assert_same(jkv.quantize_kv(jnp.asarray(x)), tbuf)
    assert tbuf.q.dtype == torch.int8 and tbuf.s.dtype == torch.float32
    np.testing.assert_array_equal(
        tkv.dequantize_kv(tbuf).numpy(),
        np.asarray(jkv.dequantize_kv(to_jax(tbuf))))
    bf = tkv.quantize_kv(torch.tensor(x).to(torch.bfloat16))
    assert_same(jkv.quantize_kv(jnp.asarray(x).astype(jnp.bfloat16)), bf)


@pytest.mark.parametrize("phase", [0, 5])
def test_rel_pos_mha_over_int8_cache_matches_jax(phase):
    rng = np.random.default_rng(7 + phase)
    B, H, Dh, lc, s_buf = 3, 4, 16, 8, 16
    D = H * Dh
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    x, pe = r(B, 1, D), r(2 * (lc + 1) - 1, D)
    ws = [r(D, D, sc=D ** -0.5) for _ in range(5)]
    bu, bv = r(H, Dh, sc=0.1), r(H, Dh, sc=0.1)
    kq = tkv.quantize_kv(torch.tensor(r(B, H, s_buf, Dh)))
    vq = tkv.quantize_kv(torch.tensor(r(B, H, s_buf, Dh)))
    valid = np.array([lc, 3, 0])
    jj, onehot = j_consts(lc, 1, s_buf, phase)
    mask = np.where(jj[None, :] < (lc - valid)[:, None], -1e9, 0.0
                    ).astype(np.float32)
    want = j_mha(jnp.asarray(x), jnp.asarray(pe), *map(jnp.asarray, ws),
                 jnp.asarray(bu), jnp.asarray(bv), H, Dh, to_jax(kq),
                 to_jax(vq), jnp.asarray(onehot), jnp.asarray(mask))
    _, pos_index = t_consts(lc, 1, s_buf, phase)
    got = t_mha(torch.tensor(x), torch.tensor(pe), *map(torch.tensor, ws),
                torch.tensor(bu), torch.tensor(bv), H, Dh, kq, vq,
                torch.tensor(pos_index[0]), torch.tensor(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_int8_core_dead_slots_weigh_exactly_zero():
    rng = np.random.default_rng(2)
    B, H, S, Dh = 3, 2, 12, 16
    r = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    q, kn, vn = r(B, H, Dh), r(B, H, Dh), r(B, H, Dh)
    kq, vq = tkv.quantize_kv(r(B, H, S, Dh)), tkv.quantize_kv(r(B, H, S, Dh))
    pm = r(B, H, S + 1) * 0.25
    pm[1, :, :5] = -1e9
    want = t1_attention_core_ref(q, kn, vn, pm, kq, vq)
    deq = [tkv.dequantize_kv(b) for b in (kq, vq)]  # the dense equivalent
    torch.testing.assert_close(
        want, t1_attention_core_ref(q, kn, vn, pm, *deq), atol=1e-5, rtol=0)
    for buf in (kq, vq):  # garbage codes and scales in dead slots
        buf.q[1, :, :5] = 127
        buf.s[1, :, :5] = 3.0e4
    got = t1_attention_core(q, kn, vn, pm, kq, vq)  # CPU: the plain version
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_state_and_cache_moves_equal_jax(monkeypatch):
    monkeypatch.setenv("NEMOTRON_TPU_KV_INT8", "1")
    hp = tiny_hparams()
    cfg = CacheConfig.for_mode(0, hp)
    B = 4
    js = jstate.init_stream_state(B, hp, cfg)
    ts = tstate.init_stream_state(B, hp, cfg, kv_int8=True)
    assert jkv.is_quant(js.k_cache) and tkv.is_quant(ts.k_cache)
    assert_same(js.k_cache, ts.k_cache)
    rng = np.random.default_rng(4)
    for name in ("k_cache", "v_cache"):  # random content in both
        shape = getattr(ts, name).q.shape
        buf = tkv.quantize_kv(torch.tensor(
            rng.standard_normal(shape).astype(np.float32)))
        setattr(ts, name, buf)
        js = dataclasses.replace(js, **{name: to_jax(buf)})
    mask = np.array([True, False, True, False])
    js = jstate.reset_slots(js, mask, hp)
    ts = tstate.reset_slots(ts, mask, hp)
    assert not ts.k_cache.q[:, 0].any() and not ts.v_cache.s[:, 2].any()
    k, v = js.k_cache, js.v_cache
    steps = ((jenc.compact_cache, tenc.compact_cache, dict(phase=3)),
             (jenc.compact_cache, tenc.compact_cache,
              dict(mask=np.array([False, True, True, False]))),
             (jenc.realign_cache, tenc.realign_cache,
              dict(delta=2, mask=np.array([True, True, False, False]))),
             (jenc.realign_cache, tenc.realign_cache,
              dict(delta=-5, mask=np.array([False, True, False, True]))))
    for jfn, tfn, kw in steps:
        jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
               for n, a in kw.items()}
        tkw = {n: torch.tensor(a) if isinstance(a, np.ndarray) else a
               for n, a in kw.items()}
        k, v = jfn(cfg, hp, k, v, **jkw)
        tfn(cfg, hp, ts.k_cache, ts.v_cache, **tkw)  # in place
        assert_same(k, ts.k_cache)
        assert_same(v, ts.v_cache)


@pytest.mark.parametrize("segment", list(SEGMENTS))
def test_q8_kv_int8_tick_matches_jax(monkeypatch, segment):
    monkeypatch.setenv("NEMOTRON_TPU_KV_INT8", "1")
    run = run_segment(segment, quant_bits=8, kv_int8=True)
    assert tkv.is_quant(run.ts.k_cache) and jkv.is_quant(run.js.k_cache)


@pytest.mark.parametrize("segment", list(SEGMENTS))
def test_bf16_q8_kv_int8_tick_within_bound(monkeypatch, segment):
    """The serving form (bf16, Q8_0, int8 caches) under the bf16 rule."""
    monkeypatch.setenv("NEMOTRON_TPU_KV_INT8", "1")
    run = run_segment(segment, bf16=True, quant_bits=8, kv_int8=True)
    assert run.ts.conv_cache.dtype == torch.bfloat16
    assert run.ts.k_cache.q.dtype == torch.int8
