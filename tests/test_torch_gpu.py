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
from nemotron_tpu_torch.ops.attn_kernel import (t1_attention_core,
                                                t1_attention_core_ref)
from nemotron_tpu_torch.ops.mel import padded_window
from nemotron_tpu_torch.ops.mel_kernel import mel_frames, mel_frames_ref
from nemotron_tpu_torch.params import params_to

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


def test_tiny_tick_on_card_matches_cpu(cuda):
    hp = Hparams(n_mels=32, d_model=64, n_heads=4, d_head=16, d_ff=96,
                 n_layers=2, kernel_size=5, vocab_size=33, decoder_dim=32,
                 joint_dim=32, subsampling_channels=16, att_left_context=8,
                 max_pos_len=64)
    cpu = ASRModel.random(hp, seed=1)
    gpu = ASRModel(hp, params_to(cpu.params, cuda), cpu.tokenizer.vocab,
                   device=cuda)
    cfg = cpu.cache_config(0)
    rng = np.random.default_rng(2)
    states = [m.init_stream_state(3, cfg) for m in (cpu, gpu)]
    before = kernels.T1_ATTENTION.launches
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
    assert kernels.T1_ATTENTION.launches - before == hp.n_layers * (i + 1)
    for name in ("k_cache", "v_cache", "conv_cache", "pp_tail", "mel_ov"):
        torch.testing.assert_close(getattr(states[1], name).cpu(),
                                   getattr(states[0], name), atol=1e-4,
                                   rtol=0)
