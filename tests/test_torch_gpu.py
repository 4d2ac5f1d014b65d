"""Kernel tests that need a CUDA card (marker `gpu`; they skip elsewhere).

On the card:  python -m pytest --noconftest -p no:cacheprovider -m gpu \\
                  tests/test_torch_gpu.py
(--noconftest: the card's machine has no jax, which tests/conftest.py
imports.) Each kernel is held against its plain PyTorch version at the
main path's shapes, and a tiny tick on the card against the same tick on
the CPU. This file imports no jax.
"""

import numpy as np
import pytest
import torch

from nemotron_tpu_torch import Hparams, kernels
from nemotron_tpu_torch.api import ASRModel
from nemotron_tpu_torch.ops import quant
from nemotron_tpu_torch.ops.attn_kernel import (t1_attention_core,
                                                t1_attention_core_ref)
from nemotron_tpu_torch.ops.kvquant import QuantKV, quantize_kv
from nemotron_tpu_torch.ops.mel import padded_window
from nemotron_tpu_torch.ops.mel_kernel import mel_frames, mel_frames_ref
from nemotron_tpu_torch.params import params_to, quantize_encoder_layers

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _attn_inputs(dev, dtype, B=32, H=8, S=78, Dh=128, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            device=dev).to(dtype)

    pm = (rng.standard_normal((B, H, S + 1)) / np.sqrt(Dh)).astype(np.float32)
    for b in range(B):
        pm[b, :, : (b * 7) % S] = -1e9  # dead slots; the new frame stays live
    return (t(B, H, Dh), t(B, H, Dh), t(B, H, Dh),
            torch.tensor(pm, device=dev), t(B, H, S, Dh), t(B, H, S, Dh))


@pytest.mark.parametrize("dtype, atol", [(torch.float32, 2e-5),
                                         (torch.bfloat16, 2e-2)])
def test_t1_attention_kernel_matches_plain(cuda, dtype, atol):
    args = _attn_inputs(cuda, dtype)
    before = kernels.T1_ATTENTION.launches
    got = t1_attention_core(*args).float()
    torch.cuda.synchronize()
    assert kernels.T1_ATTENTION.launches == before + 1
    want = t1_attention_core_ref(*args).float()
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


def test_t1_attention_dead_slots_weigh_exactly_zero(cuda):
    q, kn, vn, pm, kb, vb = _attn_inputs(cuda, torch.float32)
    vb2 = vb.clone()
    vb2[3, :, :21] = 1e6  # stream 3's dead slots hold garbage
    a = t1_attention_core(q, kn, vn, pm, kb, vb)
    b = t1_attention_core(q, kn, vn, pm, kb, vb2)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, kn, vn, pm, kb, vb = _attn_inputs(cuda, torch.float32)
    with pytest.raises(ValueError):
        t1_attention_core(q, kn, vn, pm.double(), kb, vb)
    with pytest.raises(ValueError):
        t1_attention_core(q.half(), kn.half(), vn.half(), pm, kb.half(),
                          vb.half())
    buf = torch.zeros(2, 600, device=cuda)
    with pytest.raises(ValueError):  # 600 samples < 2 frames
        mel_frames(buf, torch.ones(512, device=cuda),
                   torch.ones(128, 257, device=cuda), 2)


def _int8_caches(kb, vb):
    """Int8 caches of kb / vb with garbage codes and scales in the slots
    that _attn_inputs marks dead."""
    bufs = []
    for x in (kb, vb):
        buf = quantize_kv(x.float())
        for b in range(x.shape[0]):
            dead = (b * 7) % x.shape[2]
            buf.q[b, :, :dead] = 127
            buf.s[b, :, :dead] = 3.0e4
        bufs.append(buf)
    return bufs


@pytest.mark.parametrize("dtype, atol", [(torch.float32, 2e-5),
                                         (torch.bfloat16, 2e-2)])
def test_t1_attention_int8_kernel_matches_plain(cuda, dtype, atol):
    q, kn, vn, pm, kb, vb = _attn_inputs(cuda, dtype)
    kq, vq = _int8_caches(kb, vb)
    before = kernels.T1_ATTENTION.launches
    got = t1_attention_core(q, kn, vn, pm, kq, vq)
    torch.cuda.synchronize()
    assert kernels.T1_ATTENTION.launches == before + 1
    assert got.dtype == dtype
    want = t1_attention_core_ref(q, kn, vn, pm, kq, vq)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    kq.q[3, :, :21] = -5  # other garbage in stream 3's dead slots
    torch.testing.assert_close(t1_attention_core(q, kn, vn, pm, kq, vq), got,
                               atol=0, rtol=0)


# (M, N, K): the main path's shapes, M = 141 (the position projection),
# and ragged M and N
GEMM_SHAPES = [(256, 4096, 1024), (141, 1024, 1024), (7, 1024, 4096),
               (33, 200, 128)]


@pytest.mark.parametrize("m, n, k", GEMM_SHAPES)
@pytest.mark.parametrize("dtype, rel", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_linear_kernels_match_plain(cuda, bits, dtype, rel, m, n,
                                              k):
    rng = np.random.default_rng(m + n + k)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    qt = (quant.quantize_q8 if bits == 8 else quant.quantize_q4)(w).to(cuda)
    x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32),
                     device=cuda).to(dtype)
    kern = kernels.Q8_MATMUL if bits == 8 else kernels.Q4_MATMUL
    fn, ref = ((quant.linear_q8, quant.linear_q8_ref) if bits == 8
               else (quant.linear_q4, quant.linear_q4_ref))
    before = kern.launches
    got = fn(x, qt)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    want = ref(x, qt).float()
    err = float((got.float() - want).abs().max())
    assert err <= rel * float(want.abs().max()), err


def test_quantized_linear_wrappers_refuse(cuda):
    qt = quant.quantize_q8(np.ones((64, 64), np.float32)).to(cuda)
    x = torch.ones(4, 64, device=cuda)
    with pytest.raises(ValueError):  # fp16 activations
        quant.linear_q8(x.half(), qt)
    with pytest.raises(ValueError):  # x does not match K
        quant.linear_q8(torch.ones(4, 32, device=cuda), qt)
    with pytest.raises(ValueError):  # K % 32 != 0
        quant.linear_q8(torch.ones(4, 48, device=cuda), quant.QuantizedTensor(
            torch.zeros(8, 48, dtype=torch.int8, device=cuda),
            torch.ones(8, 1, device=cuda)))
    with pytest.raises(ValueError):  # stacked weights: index the layer first
        quant.linear_q8(x, quant.QuantizedTensor(qt.w_i8[None], qt.scales[None]))


def test_mel_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    buf = torch.tensor((rng.standard_normal((32, 1632)) * 0.1).astype(
        np.float32), device=cuda)
    fb = torch.tensor(rng.uniform(0, 1, (128, 257)).astype(np.float32),
                      device=cuda)
    win = padded_window(torch.tensor(np.hanning(400).astype(np.float32),
                                     device=cuda))
    before = kernels.MEL_FRAMES.launches
    got = mel_frames(buf, win, fb, 8)
    torch.cuda.synchronize()
    assert kernels.MEL_FRAMES.launches == before + 1
    torch.testing.assert_close(got, mel_frames_ref(buf, win, fb, 8),
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_tiny_tick_on_card_matches_cpu(cuda, int8):
    """Dense, or Q8_0 weights with int8 K/V caches (codes within +-1)."""
    hp = Hparams(n_mels=32, d_model=64, n_heads=4, d_head=16, d_ff=96,
                 n_layers=2, kernel_size=5, vocab_size=33, decoder_dim=32,
                 joint_dim=32, subsampling_channels=16, att_left_context=8,
                 max_pos_len=64)
    cpu = ASRModel.random(hp, seed=1, kv_int8=int8)
    if int8:
        cpu.params = quantize_encoder_layers(cpu.params)
    gpu = ASRModel(hp, params_to(cpu.params, cuda), cpu.tokenizer.vocab,
                   device=cuda, kv_int8=int8)
    cfg = cpu.cache_config(0)
    rng = np.random.default_rng(2)
    states = [m.init_stream_state(3, cfg) for m in (cpu, gpu)]
    kernels.reset_counts()
    for i in range(cfg.n_phases + 2):
        audio = (rng.standard_normal((3, cfg.shift_samples)) * 3000).astype(
            np.int16)
        packed = cpu.pack_tick_inputs(audio, np.ones(3), np.zeros(3), None)
        toks = []
        for j, m in enumerate((cpu, gpu)):
            states[j], t = m.fused_tick_packed(
                cfg, states[j], m.put_batch(packed), True,
                phase=i % cfg.n_phases)
            if (i + 1) % cfg.n_phases == 0:
                states[j] = m.compact_state(cfg, states[j])
            toks.append(t.cpu())
        torch.testing.assert_close(toks[1], toks[0], atol=0, rtol=0)
    assert kernels.T1_ATTENTION.launches == hp.n_layers * (i + 1)
    assert kernels.Q8_MATMUL.launches == (11 * hp.n_layers * (i + 1) if int8
                                          else 0)
    for name in ("k_cache", "v_cache", "conv_cache", "pp_tail", "mel_ov"):
        got, want = getattr(states[1], name), getattr(states[0], name)
        if isinstance(want, QuantKV):
            torch.testing.assert_close(got.q.cpu().float(), want.q.float(),
                                       atol=1, rtol=0)
            got, want = got.s, want.s
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
