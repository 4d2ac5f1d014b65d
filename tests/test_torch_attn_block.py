"""Kernel B3, the fused T=1 attention block: the port's plain version against
the JAX package's Pallas block (ops/attn_block_pallas.py, interpret mode on
the CPU), the port's streaming encoder with the block against the JAX
package's with its NEMOTRON_TPU_PALLAS_ATTN_BLOCK path and against the
port without the block, and the fused tick with the block over the
slack-buffer wrap, masked ticks with realign and a k=8 tick, tokens equal
to JAX's (over dense caches, and over int8 caches for the wrap and the
masked ticks).

Tolerances: the block in f32 within 1e-5 of max|out| (sums in another
order); in bf16 within 4 bf16 ulps of max|out| (2^-5 x max, the bf16 rule
of tests/test_torch_tick.py: XLA and PyTorch round bf16 at other points);
over int8 caches, which the port reads as they are and JAX dequantizes
first, within 1e-5 (rounding order only); the encoder within 5e-5, as
tests/test_modules.py holds the JAX block against JAX's default path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg, tiny_hparams
from test_torch_tick import (SEGMENTS, Lockstep, assert_states_close,
                             make_audio, run_segment)

from nemotron_tpu.models import encoder as ENC
from nemotron_tpu.ops.attn_block_pallas import t1_attention_block as j_block
from nemotron_tpu.params import random_params as j_random
from nemotron_tpu_torch.api import ASRModel as TorchModel
from nemotron_tpu_torch.models import encoder as te
from nemotron_tpu_torch.ops.attn_block import (t1_attention_block,
                                               t1_attention_block_ref)
from nemotron_tpu_torch.ops.kvquant import QuantKV
from nemotron_tpu_torch.params import quantize_encoder_layers
from nemotron_tpu_torch.params import random_params as t_random
from nemotron_tpu_torch.config import CacheConfig
from nemotron_tpu_torch.streaming.engine import PRIME_SAMPLES

torch.set_num_threads(1)

B, H, DH, S = 4, 4, 16, 12
D = H * DH
BF16_REL = 2.0 ** -5


def block_inputs(seed):
    """Numpy inputs of one block call: random validity windows (dead slots
    at -1e9, pp zero there), the new frame always live."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    live = np.zeros((B, S + 1), bool)
    for b in range(B):
        lo = int(rng.integers(0, S))
        live[b, lo:S] = True
    live[:, S] = True
    pp = r(H, DH, S + 1) * live.any(0)
    mask = np.where(live, 0.0, -1e9).astype(np.float32)
    return dict(x=r(B, D), ln_w=1 + r(D, scale=0.1), ln_b=r(D, scale=0.1),
                q_w=r(D, D, scale=D ** -0.5), k_w=r(D, D, scale=D ** -0.5),
                v_w=r(D, D, scale=D ** -0.5), out_w=r(D, D, scale=D ** -0.5),
                bias_u=r(H, DH, scale=0.1), bias_v=r(H, DH, scale=0.1),
                pp=pp, mask=mask, k_buf=r(B, H, S, DH), v_buf=r(B, H, S, DH)), live


def run_jax(a, dtype):
    cast = {k: jnp.asarray(v, dtype=jnp.float32 if k == "pp" else dtype)
            for k, v in a.items()}
    out, (kn, vn) = j_block(**cast, n_heads=H, d_head=DH, interpret=True)
    return [np.asarray(t, dtype=np.float32) for t in (out, kn, vn)]


def run_port(a, dtype, k_buf=None, v_buf=None):
    t = {k: torch.tensor(v).to(torch.float32 if k == "pp" else dtype)
         for k, v in a.items()}
    if k_buf is not None:
        t["k_buf"], t["v_buf"] = k_buf, v_buf
    outs = t1_attention_block(**t, n_heads=H, d_head=DH)
    return [o.float().numpy() for o in outs]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_block_matches_jax_pallas_block(dtype):
    a, _ = block_inputs(seed=1)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    want = run_jax(a, jd)
    got = run_port(a, td)
    for name, g, w in zip(("out", "k_new", "v_new"), got, want):
        assert g.shape == w.shape, name
        rel = 1e-5 if dtype == "f32" else BF16_REL
        np.testing.assert_allclose(g, w, atol=rel * np.abs(w).max(), rtol=0,
                                   err_msg=name)


def test_plain_block_over_int8_caches_matches_jax_dequantized():
    """The port reads codes and per-frame scales; JAX's block gets the
    dequantized caches. Dead slots hold garbage codes and scales."""
    a, live = block_inputs(seed=2)
    rng = np.random.default_rng(3)
    bufs = {}
    for name in ("k_buf", "v_buf"):
        q = rng.integers(-127, 128, (B, H, S, DH)).astype(np.int8)
        s = rng.uniform(0.001, 0.02, (B, H, S)).astype(np.float32)
        dead = ~live[:, None, :S]
        q[np.broadcast_to(dead[..., None], q.shape)] = 127
        s[np.broadcast_to(dead, s.shape)] = 3.0e4
        a[name] = q.astype(np.float32) * s[..., None]
        bufs[name] = QuantKV(torch.tensor(q), torch.tensor(s))
    want = run_jax(a, jnp.float32)
    got = run_port(a, torch.float32, bufs["k_buf"], bufs["v_buf"])
    for name, g, w in zip(("out", "k_new", "v_new"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(), rtol=0,
                                   err_msg=name)


def test_wrapper_takes_the_plain_version_on_cpu():
    a, _ = block_inputs(seed=4)
    t = {k: torch.tensor(v) for k, v in a.items()}
    for g, w in zip(t1_attention_block(**t, n_heads=H, d_head=DH),
                    t1_attention_block_ref(**t, n_heads=H, d_head=DH)):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def enc_setup():
    hp = tiny_hparams()
    return hp, tiny_cfg(hp), j_random(hp, seed=7), t_random(hp, seed=7, device="cpu")


@pytest.mark.parametrize("masked", [False, True])
def test_stream_encode_with_block_matches_jax_and_port_default(
        enc_setup, monkeypatch, masked):
    """Phases 0-2 from one state: the port with the block against JAX with
    its Pallas block, and against the port without the block; the masked
    fast path pauses stream 1 on phase 1."""
    hp, cfg, jp, tp = enc_setup
    monkeypatch.setattr(ENC, "PALLAS_ATTN_BLOCK", True)
    rng = np.random.default_rng(8)
    s_buf = cfg.cache_buf_len(hp)
    kv = [rng.standard_normal((hp.n_layers, B, hp.n_heads, s_buf, hp.d_head)
                              ).astype(np.float32) for _ in range(2)]
    conv = rng.standard_normal((hp.n_layers, B, cfg.conv_cache_size,
                                hp.d_model)).astype(np.float32)
    valid = np.array([0, 3, 8, 5], np.int32)
    j_st = [jnp.asarray(t) for t in (*kv, conv, valid)]
    t_st = {blk: [torch.tensor(t) for t in (*kv, conv, valid)]
            for blk in (True, False)}
    for phase in range(3):
        mel = rng.standard_normal(
            (B, cfg.chunk_mel_frames, hp.n_mels)).astype(np.float32)
        act = (np.array([True, phase != 1, True, True]) if masked
               else None)
        jx, *j_st = ENC.stream_encode_step(
            jp, hp, cfg, jnp.asarray(mel), *j_st, phase=phase,
            active_mask=None if act is None else jnp.asarray(act))
        outs = {}
        for blk in (True, False):
            outs[blk], *t_st[blk] = te.stream_encode_step(
                tp, hp, cfg, torch.tensor(mel), *t_st[blk], phase=phase,
                active_mask=None if act is None else torch.tensor(act),
                attn_block=blk)
        for want, what in ((jx, "jax block"), (outs[False], "port default")):
            np.testing.assert_allclose(outs[True].numpy(), np.asarray(want),
                                       atol=5e-5, rtol=0,
                                       err_msg=f"phase {phase} vs {what}")
    for g, w in zip(t_st[True], j_st):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=0)
    if masked:  # stream 1 skipped phase 1: its append slot is untouched
        np.testing.assert_array_equal(t_st[True][0][:, 1, :, 8 + 1].numpy(),
                                      kv[0][:, 1, :, 8 + 1])


@pytest.mark.parametrize("name", ["wrap", "k8", "masked_realign"])
def test_fused_tick_with_block_matches_jax(monkeypatch, name):
    """Tokens equal to JAX's with its Pallas block; state within 1e-4."""
    monkeypatch.setattr(ENC, "PALLAS_ATTN_BLOCK", True)
    offset, seg = SEGMENTS[name]
    n_phases = CacheConfig.for_mode(0, tiny_hparams()).n_phases
    run = Lockstep(make_audio(PRIME_SAMPLES + 10 * 1280, seed=5),
                   phase=offset % n_phases, attn_block=True)
    seg(run)  # every tick asserts equal tokens
    assert_states_close(run.js, run.ts, f"after {name}")
    assert any(run.ids), run.ids


@pytest.mark.parametrize("name", ["wrap", "masked_realign"])
def test_fused_tick_with_block_over_int8_caches_matches_jax(monkeypatch,
                                                            name):
    """Int8 K/V caches: the port's block reads codes and scales, JAX's
    dequantizes them before its Pallas block; tokens equal, codes within
    +-1, the other leaves within 1e-4."""
    monkeypatch.setenv("NEMOTRON_TPU_KV_INT8", "1")
    monkeypatch.setattr(ENC, "PALLAS_ATTN_BLOCK", True)
    run = run_segment(name, kv_int8=True, attn_block=True)
    assert run.ts.k_cache.q.dtype == torch.int8


def test_quantized_attention_weights_are_refused():
    hp = tiny_hparams()
    model = TorchModel.random(hp, seed=1, device="cpu")
    q8 = quantize_encoder_layers(model.params, bits=8)
    with pytest.raises(ValueError,
                       match="dense attention weights.*attn_q_w"):
        TorchModel(hp, q8, model.tokenizer.vocab, device="cpu",
                   attn_block=True)
    # the refusal is the block's alone: without it the weights serve
    TorchModel(hp, q8, model.tokenizer.vocab, device="cpu")
