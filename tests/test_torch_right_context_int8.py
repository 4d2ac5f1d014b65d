"""Right contexts 1, 6 and 13 with int8 K/V caches: the fused tick of both
packages in lockstep over the segments of tests/test_torch_right_context.py
(wrap, k = n_phases, masked realign +, masked wrap with realign -,
finalize with a reduced n_valid), at each mode's own n_phases. Tokens
exactly equal, int8 codes within +-1, every other leaf within 1e-4. The
int8 scale folds onto the scores after the Dh reduction and onto the
softmax weights before the V product, as in the JAX package.

bf16 (bf16 weights, dense caches) at R=13 under the bf16 rule: the
encoder leaves within 2^-5 of each leaf's largest magnitude
(tests/test_torch_tick.py); tokens are not compared (near-tie argmaxes of
the random weights flip under bf16 rounding).

bf16 with Q8_0 encoder matrices and int8 K/V caches (the card's serving
form) at R=13. The one product that feeds the caches, a layer's bf16
Q8_0 projection at the tiny geometry, is bit-equal in both packages, and
so are the codes quantize_kv makes of it (test_bf16_q8_projection_...):
the port casts as the JAX package does. What differs is the drift of the
bf16 activations between the two CPU backends (XLA keeps f32 inside a
fusion, eager PyTorch rounds after every op), which the bf16 rule bounds
for a dense value v: |v_port - v_jax| <= 2^-5 max|v|. int8 codes amplify
that drift by 1 / s_f, s_f = amax_f / 127 the frame's scale: a frame whose
amax is a quarter of the leaf's largest value sees its codes move four
times as far for the same drift (4 of 13,824 codes 4 apart in the finalize
segment under the old rule of 2^-5 x 127 codes, PR 8). The bf16 rule on
the values the cache stores follows: q s = v + e with |e| <= s / 2 in
each package, so |q_p s_p - q_j s_j| <= 2^-5 max|q_j s_j| + max s. The
codes are held so, dequantized; every other encoder leaf under the bf16
rule itself."""

import dataclasses

import numpy as np
import pytest
import torch

from helpers import tiny_hparams
from test_torch_right_context import MODES, SEGMENTS, run_segment
from test_torch_tick import BF16_REL, assert_states_close, leaves

import jax.numpy as jnp
from nemotron_tpu.ops import kvquant as jkv
from nemotron_tpu.ops import quant as jq
from nemotron_tpu_torch.ops import kvquant as tkv
from nemotron_tpu_torch.ops import quant as tq

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(SEGMENTS))
@pytest.mark.parametrize("mode", MODES)
def test_kv_int8_tick_matches_jax(monkeypatch, mode, name):
    monkeypatch.setenv("NEMOTRON_TPU_KV_INT8", "1")  # the JAX package's
    run = run_segment(mode, name, kv_int8=True)
    assert tkv.is_quant(run.ts.k_cache) and jkv.is_quant(run.js.k_cache)


@pytest.mark.parametrize("name", list(SEGMENTS))
def test_bf16_tick_within_bound_at_r13(name):
    run = run_segment(13, name, bf16=True)
    assert run.ts.k_cache.dtype == torch.bfloat16
    assert run.ts.pp_tail.dtype == torch.float32  # the frontend stays f32


def test_bf16_q8_projection_and_codes_are_bit_equal():
    """A layer's K/V projection in bf16 with Q8_0 weights at R=13's rows
    (B=3 x chunk_len 14) and the tiny widths, then quantize_kv: the same
    bf16 input gives the same bf16 output and the same codes and scales in
    both packages."""
    hp = tiny_hparams()
    rng = np.random.default_rng(8)
    w = (rng.standard_normal((hp.n_heads * hp.d_head, hp.d_model))
         / np.sqrt(hp.d_model)).astype(np.float32)
    x = rng.standard_normal((3, 14, hp.d_model)).astype(np.float32)
    tqt = tq.quantize_q8(w)
    jqt = jq.QuantizedTensor(w_i8=jnp.asarray(tqt.w_i8.numpy()),
                             scales=jnp.asarray(tqt.scales.numpy()))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(x, jnp.bfloat16)
    np.testing.assert_array_equal(tx.float().numpy(),
                                  np.asarray(jx, np.float32))
    ty = tq.linear_q8_ref(tx, tqt)
    jy = jq.linear_q8_xla(jx, jqt)
    assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(jy, np.float32))
    shape = (3, 14, hp.n_heads, hp.d_head)
    tc = tkv.quantize_kv(ty.reshape(shape))
    jc = jkv.quantize_kv(jy.reshape(shape))
    np.testing.assert_array_equal(tc.q.numpy(), np.asarray(jc.q))
    np.testing.assert_array_equal(tc.s.numpy(), np.asarray(jc.s))


def assert_bf16_int8_states_close(js, ts, where, bf16):
    """The bf16 rule (assert_states_close) on every leaf but the codes; the
    codes dequantized with their frame scales, within 2^-5 of the cache's
    largest stored value plus the largest code step (module docstring)."""
    assert bf16
    jl, tl = leaves(js), leaves(ts)
    for name in ("k_cache", "v_cache"):
        jv = jl[name + ".q"] * jl[name + ".s"][..., None]
        tv = tl[name + ".q"] * tl[name + ".s"][..., None]
        atol = BF16_REL * np.abs(jv).max() + jl[name + ".s"].max()
        np.testing.assert_allclose(tv, jv, atol=atol, rtol=0,
                                   err_msg=f"{where}: {name} dequantized")
    assert_states_close(_without_codes(js), _without_codes(ts), where, bf16)


def _without_codes(state):
    """The state with each int8 cache's codes zeroed (their scales kept):
    assert_states_close then holds every other leaf."""
    def strip(buf):
        if not hasattr(buf, "q"):
            return buf
        q = buf.q
        zero = (torch.zeros_like(q) if isinstance(q, torch.Tensor)
                else jnp.zeros_like(q))
        return type(buf)(zero, buf.s)

    return dataclasses.replace(state, k_cache=strip(state.k_cache),
                               v_cache=strip(state.v_cache))


@pytest.mark.parametrize("name", list(SEGMENTS))
def test_bf16_q8_kv_int8_tick_within_bound_at_r13(monkeypatch, name):
    monkeypatch.setenv("NEMOTRON_TPU_KV_INT8", "1")
    run = run_segment(13, name, check=assert_bf16_int8_states_close,
                      bf16=True, quant_bits=8, kv_int8=True)
    assert tkv.is_quant(run.ts.k_cache) and tq.is_quantized(
        run.tm.params.layers.attn_q_w)
