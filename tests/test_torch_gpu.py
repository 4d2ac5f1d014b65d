"""Kernel tests that need a CUDA card (marker `gpu`; they skip elsewhere).

On the card:  python -m pytest --noconftest -p no:cacheprovider -m gpu \\
                  tests/test_torch_gpu.py
(--noconftest: the card's machine has no jax, which tests/conftest.py
imports.) Each kernel is held against its plain PyTorch version at the
main path's shapes, and a tiny tick on the card against the same tick on
the CPU. This file imports no jax.
"""

import contextlib

import numpy as np
import pytest
import torch

from nemotron_tpu_torch import Hparams, kernels
from nemotron_tpu_torch.api import ASRModel
from nemotron_tpu_torch.audio.frontend import mel_full, process_many
from nemotron_tpu_torch.ops import quant
from nemotron_tpu_torch.ops.attn_block import (t1_attention_block,
                                               t1_attention_block_ref)
from nemotron_tpu_torch.ops.attn_kernel import (t1_attention_core,
                                                t1_attention_core_ref)
from nemotron_tpu_torch.ops.kvquant import QuantKV, quantize_kv
from nemotron_tpu_torch.ops.mel import padded_window
from nemotron_tpu_torch.ops.mel_kernel import mel_frames, mel_frames_ref
from nemotron_tpu_torch.params import (QUANT_LAYER_FIELDS, params_to,
                                      quantize_encoder_layers)
from nemotron_tpu_torch.tools.gemm_turns import mel_exact, slaney_filterbank

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


# (S_buf, d_head, n_heads): the full-width model's and the tiny geometry's
ATTN_GEOMS = [(78, 128, 8), (16, 16, 4)]


@pytest.mark.parametrize("geom", ATTN_GEOMS, ids=["full", "tiny"])
@pytest.mark.parametrize("b", [1, 7, 32, 256])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 2e-5),
                                         (torch.bfloat16, 2e-2)])
def test_t1_attention_kernel_matches_plain(cuda, dtype, atol, int8, b, geom):
    """B1 (bulk copies, 16-byte shared reads; a block or a cluster per
    pair, as attn_plan says) against its plain version, dense and int8
    caches; garbage in the dead slots changes no bit."""
    S, Dh, H = geom
    q, kn, vn, pm, kb, vb = _attn_inputs(cuda, dtype, B=b, H=H, S=S, Dh=Dh)
    if int8:
        kb, vb = _int8_caches(kb, vb)
    before = kernels.T1_ATTENTION.launches
    got = t1_attention_core(q, kn, vn, pm, kb, vb)
    torch.cuda.synchronize()
    assert kernels.T1_ATTENTION.launches == before + 1
    assert got.dtype == dtype
    want = t1_attention_core_ref(q, kn, vn, pm, kb, vb)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    dead = (3 * 7) % S if b > 3 else 0
    if int8:  # other garbage codes and scales in stream 3's dead slots
        kb.q[3:4, :, :dead] = -5
        vb.s[3:4, :, :dead] = -7.0
    else:
        vb[3:4, :, :dead] = 1e6
    torch.testing.assert_close(t1_attention_core(q, kn, vn, pm, kb, vb), got,
                               atol=0, rtol=0)


def test_t1_attention_dead_slots_weigh_exactly_zero(cuda):
    q, kn, vn, pm, kb, vb = _attn_inputs(cuda, torch.float32)
    vb2 = vb.clone()
    vb2[3, :, :21] = 1e6  # stream 3's dead slots hold garbage
    a = t1_attention_core(q, kn, vn, pm, kb, vb)
    b = t1_attention_core(q, kn, vn, pm, kb, vb2)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 2e-5),
                                         (torch.bfloat16, 2e-2)])
def test_t1_attention_cluster_plan_at_the_servers_batch(cuda, dtype, atol,
                                                        int8):
    """At batch 8 (64 pairs) the plan splits each pair's slots over a
    cluster; stream 3's share of dead slots weighs exactly 0."""
    from nemotron_tpu_torch.ops.attn_kernel import attn_plan, sm_count

    plan = attn_plan(8 * 8, 78, sm_count(cuda))
    assert plan.cluster > 1
    q, kn, vn, pm, kb, vb = _attn_inputs(cuda, dtype, B=8)
    if int8:
        kb, vb = _int8_caches(kb, vb)
    got = t1_attention_core(q, kn, vn, pm, kb, vb)
    want = t1_attention_core_ref(q, kn, vn, pm, kb, vb)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert torch.equal(t1_attention_core(q, kn, vn, pm, kb, vb), got)


@pytest.mark.parametrize("dtype, int8, atol", [
    (torch.float32, False, 2e-5), (torch.bfloat16, False, 2e-2),
    (torch.float32, True, 2e-5)], ids=["f32", "bf16", "int8"])
def test_t1_attention_at_the_largest_s_buf_the_shape_rule_takes(
        cuda, dtype, int8, atol):
    """check_shape's Python copy of the kernel's shared-memory layout
    (ops/attn_kernel.py:b1_smem) decides which S_buf the wrapper takes: at
    the largest one, with a block per pair (17 streams x 8 heads > 132
    SMs), the kernel launches and agrees with its plain version, so the
    copy is not smaller than the kernel's own layout."""
    from nemotron_tpu_torch.ops.attn_kernel import check_shape

    elem = 1 if int8 else dtype.itemsize

    def takes(s):
        try:
            check_shape(128, elem, s)
        except ValueError:
            return False
        return True

    s_buf = max(s for s in range(1, 2048) if takes(s))
    q, kn, vn, pm, kb, vb = _attn_inputs(cuda, dtype, B=17, S=s_buf)
    if int8:
        kb, vb = _int8_caches(kb, vb)
    got = t1_attention_core(q, kn, vn, pm, kb, vb)
    want = t1_attention_core_ref(q, kn, vn, pm, kb, vb)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, kn, vn, pm, kb, vb = _attn_inputs(cuda, torch.float32)
    with pytest.raises(ValueError):
        t1_attention_core(q, kn, vn, pm.double(), kb, vb)
    with pytest.raises(ValueError):
        t1_attention_core(q.half(), kn.half(), vn.half(), pm, kb.half(),
                          vb.half())
    a = _attn_inputs(cuda, torch.bfloat16, B=2, Dh=24)  # 48-byte rows
    with pytest.raises(ValueError):
        t1_attention_core(*a)
    flat = torch.zeros(kb.numel() + 1, device=cuda)
    shifted = flat[1:].view(kb.shape)  # contiguous, 4 bytes off 16
    with pytest.raises(ValueError):
        t1_attention_core(q, kn, vn, pm, shifted, vb)
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


@pytest.mark.parametrize("k", [64, 1024, 4096])
@pytest.mark.parametrize("n", [1024, 2048, 4096])
@pytest.mark.parametrize("bits", [8, 4])
def test_hopper_quantized_linears_bf16(cuda, bits, n, k):
    """B4 / B5 with bf16 activations (the wgmma body, its split-K plans)
    against the plain versions within 1e-2 x max|y| at every batch the
    path sees and beyond 256 rows; two calls give identical bits (the
    splits are reduced in a fixed order); one launch counted per call."""
    rng = np.random.default_rng(n + k + bits)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    qt = (quant.quantize_q8 if bits == 8 else quant.quantize_q4)(w).to(cuda)
    kern = kernels.Q8_MATMUL if bits == 8 else kernels.Q4_MATMUL
    fn, ref = ((quant.linear_q8, quant.linear_q8_ref) if bits == 8
               else (quant.linear_q4, quant.linear_q4_ref))
    for m in (1, 8, 32, 141, 256, 300):
        x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32),
                         device=cuda).to(torch.bfloat16)
        before = kern.launches
        got = fn(x, qt)
        again = fn(x, qt)
        torch.cuda.synchronize()
        assert kern.launches == before + 2
        assert got.dtype == torch.bfloat16 and got.shape == (m, n)
        assert torch.equal(got, again), m
        want = ref(x, qt).float()
        err = float((got.float() - want).abs().max())
        assert err <= 1e-2 * float(want.abs().max()), (m, err)


F32_SHAPES = [(4096, 1024), (1024, 4096), (2048, 1024), (1024, 1024),
              (128, 4096)]  # the last: one tile, the plan's most splits


@pytest.mark.parametrize("n, k", F32_SHAPES)
@pytest.mark.parametrize("bits", [8, 4])
def test_f32_quantized_linears_at_every_plan(cuda, bits, n, k):
    """B4 / B5 with f32 activations (the FFMA body on ops/quant.py:f32_plan,
    split-K summed by each tile's last block) against the plain versions
    within 1e-5 x max|y| at the encoder's shapes and ragged batches; two
    calls give identical bits; one launch counted per call."""
    rng = np.random.default_rng(n + k + bits + 1)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    qt = (quant.quantize_q8 if bits == 8 else quant.quantize_q4)(w).to(cuda)
    kern = kernels.Q8_MATMUL if bits == 8 else kernels.Q4_MATMUL
    fn, ref = ((quant.linear_q8, quant.linear_q8_ref) if bits == 8
               else (quant.linear_q4, quant.linear_q4_ref))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for m in (1, 17, 141, 256):
        x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32),
                         device=cuda)
        before = kern.launches
        got = fn(x, qt)
        again = fn(x, qt)
        torch.cuda.synchronize()
        assert kern.launches == before + 2
        assert got.dtype == torch.float32 and got.shape == (m, n)
        assert torch.equal(got, again), m
        want = ref(x, qt)
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (
            m, quant.f32_plan(m, n, k, sms), err)


# M = B x chunk_len at B=256 and right context 1 / 6 / 13, and a ragged
# 1974 = 141 x 14
RC_ROWS = (512, 1792, 3584, 1974)


@pytest.mark.parametrize("n, k", F32_SHAPES[:4])
@pytest.mark.parametrize("dtype, rel", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_linears_at_right_context_rows(cuda, bits, dtype, rel, n,
                                                 k):
    """B4 / B5 at the rows of the right-context ticks, on the plans
    gemm_plan / f32_plan give them: within rel x max|y| of the plain
    version, two calls bit-equal, one launch each; in f32 the workspace
    f32_scratch makes holds every split's partial of every tile."""
    _quantized_linears_at_rows(cuda, bits, dtype, rel, n, k, RC_ROWS)


# M = B x T' of the offline path: 8 short files x 129 frames (one 1024-frame
# bucket), one full segment (2,048), 8 full segments (16,384)
OFFLINE_ROWS = (1032, 2048, 16384)


@pytest.mark.parametrize("n, k", F32_SHAPES[:4])
@pytest.mark.parametrize("dtype, rel", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_linears_at_offline_rows(cuda, bits, dtype, rel, n, k):
    """B4 / B5 at the offline path's rows, as at the right-context rows."""
    _quantized_linears_at_rows(cuda, bits, dtype, rel, n, k, OFFLINE_ROWS)


# ragged rows past gemm_plan's crossover (bf16: the large-M form)
LARGE_RAGGED_ROWS = (3583, 6151)


@pytest.mark.parametrize("n, k", F32_SHAPES[:4])
@pytest.mark.parametrize("dtype, rel", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_linears_at_ragged_large_rows(cuda, bits, dtype, rel, n,
                                                k):
    """B4 / B5 at ragged rows of many streams (M % 128 != 0): in bf16 on
    the large-M form (the weight dequantized once, then the persistent
    wgmma GEMM, masked on the ragged tile), as at the right-context
    rows."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if dtype == torch.bfloat16:
        for m in LARGE_RAGGED_ROWS:
            assert isinstance(quant.gemm_plan(m, n, k, bits, sms),
                              quant.LargePlan)
    _quantized_linears_at_rows(cuda, bits, dtype, rel, n, k,
                               LARGE_RAGGED_ROWS)


@pytest.mark.parametrize("bits", [8, 4])
def test_large_form_at_each_tile_width(cuda, bits):
    """The large-M form at each of its weight-row tiles (LARGE_BN), launched
    on large_plan's plan for that width: its bf16 weight scratch equal to
    the plain dequantization, y within 1e-2 x max|y| of the plain version
    at ragged M and at N that leave a part tile (136: less than one)."""
    rng = np.random.default_rng(bits + 31)
    kern = kernels.Q8_MATMUL if bits == 8 else kernels.Q4_MATMUL
    ref = quant.linear_q8_ref if bits == 8 else quant.linear_q4_ref
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for m, n, k in ((1029, 4096, 1024), (2000, 1152, 4096),
                    (1500, 136, 1024)):
        w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
        qt = (quant.quantize_q8 if bits == 8 else quant.quantize_q4)(w).to(
            cuda)
        codes = qt.w_i8 if bits == 8 else qt.w_packed
        x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32),
                         device=cuda).to(torch.bfloat16)
        want = ref(x, qt).float()
        for bn in quant.LARGE_BN:
            p = quant.large_plan(m, n, k, sms, bn)
            y = torch.full((m, n), float("nan"), dtype=torch.bfloat16,
                           device=cuda)
            wbuf = torch.empty((n, k), dtype=torch.bfloat16, device=cuda)
            kern.launch(f"q{bits}_matmul_bf16_large", x.data_ptr(),
                        codes.data_ptr(), qt.scales.data_ptr(), y.data_ptr(),
                        wbuf.data_ptr(), m, n, k, p.bn, p.blocks)
            torch.cuda.synchronize()
            assert torch.equal(wbuf, (quant.dequantize if bits == 8 else
                                      quant.dequantize_q4)(qt, torch.bfloat16))
            err = float((y.float() - want).abs().max())
            assert err <= 1e-2 * float(want.abs().max()), (m, n, k, p, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_linears_replay_in_a_cuda_graph(cuda, bits, dtype):
    """B4 / B5 at a ragged large row (bf16: the large-M form, its bf16
    weight scratch allocated in the capture) captured into a CUDA graph:
    each replay equals an eager call on the same inputs bit for bit, after
    the input changes too; the capture counts one launch."""
    rng = np.random.default_rng(bits + 41)
    m, n, k = 3583, 4096, 1024
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    qt = (quant.quantize_q8 if bits == 8 else quant.quantize_q4)(w).to(cuda)
    kern = kernels.Q8_MATMUL if bits == 8 else kernels.Q4_MATMUL
    fn = quant.linear_q8 if bits == 8 else quant.linear_q4
    x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32),
                     device=cuda).to(dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x, qt)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kern.launches
    with torch.cuda.graph(graph):
        out = fn(x, qt)
    assert kern.launches == before + 1
    for seed in (1, 2):
        x.copy_(torch.tensor(np.random.default_rng(seed).standard_normal(
            (m, k)).astype(np.float32), device=cuda).to(dtype))
        graph.replay()
        eager = fn(x, qt)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), seed


def _quantized_linears_at_rows(cuda, bits, dtype, rel, n, k, rows):
    rng = np.random.default_rng(n + k + bits + 7)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    qt = (quant.quantize_q8 if bits == 8 else quant.quantize_q4)(w).to(cuda)
    kern = kernels.Q8_MATMUL if bits == 8 else kernels.Q4_MATMUL
    fn, ref = ((quant.linear_q8, quant.linear_q8_ref) if bits == 8
               else (quant.linear_q4, quant.linear_q4_ref))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for m in rows:
        if dtype == torch.float32:
            plan = quant.f32_plan(m, n, k, sms)
            ws, cnt = quant.f32_scratch(plan, cuda)
            if plan.splits > 1:
                assert ws.shape == (plan.splits, plan.tiles,
                                    plan.bm * quant.F32_ROWS)
                assert cnt.numel() >= plan.tiles and not cnt.any()
            else:
                assert ws is None and cnt is None
        x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32),
                         device=cuda).to(dtype)
        before = kern.launches
        got = fn(x, qt)
        again = fn(x, qt)
        torch.cuda.synchronize()
        assert kern.launches == before + 2
        assert got.dtype == dtype and got.shape == (m, n)
        assert torch.equal(got, again), m
        want = ref(x, qt).float()
        err = float((got.float() - want).abs().max())
        assert err <= rel * float(want.abs().max()), (m, err)


def test_f32_split_counters_survive_alternating_shapes(cuda):
    """The per-tile counters of the f32 split-K reduction reset themselves:
    calls at alternating shapes, tile counts and splits, back to back on one
    stream, repeat their first results bit for bit."""
    rng = np.random.default_rng(5)
    cases = []
    for m, n, k in ((256, 1024, 4096), (1, 4096, 1024), (141, 1024, 1024),
                    (17, 200, 128)):
        qt = quant.quantize_q8((rng.standard_normal((n, k)) / np.sqrt(k))
                               .astype(np.float32)).to(cuda)
        x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32),
                         device=cuda)
        cases.append((x, qt, quant.linear_q8(x, qt)))
    for _ in range(3):
        outs = [quant.linear_q8(x, qt) for x, qt, _ in cases]
        torch.cuda.synchronize()
        for (x, qt, first), got in zip(cases, outs):
            assert torch.equal(got, first)
    for x, qt, first in cases:
        want = quant.linear_q8_ref(x, qt)
        assert float((first - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


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


def _mel_case(dev, b, n_frames, n_mels=128, fb_kind="dense",
              signal="noise", seed=1):
    """Kernel B2's inputs: a buffer of b streams holding n_frames frames of
    white noise (std 0.1), a full-scale 300 Hz tone with noise at -60 dB,
    or digital silence; a dense uniform filterbank (as random_params) or a
    slaney one; the 400-sample Hann window centred in 512."""
    rng = np.random.default_rng(seed)
    n_buf = (n_frames - 1) * 160 + 512
    if signal == "noise":
        x = rng.standard_normal((b, n_buf)) * 0.1
    elif signal == "tone":
        t = np.arange(n_buf) / 16000.0
        x = np.sin(2 * np.pi * 300.0 * t) + 1e-3 * rng.standard_normal(
            (b, n_buf))
    else:
        x = np.zeros((b, n_buf))
    fb = (rng.uniform(0, 1, (n_mels, 257)) if fb_kind == "dense"
          else slaney_filterbank(n_mels))
    win = padded_window(torch.tensor(np.hanning(400).astype(np.float32),
                                     device=dev))
    return (torch.tensor(x.astype(np.float32), device=dev),
            win, torch.tensor(fb.astype(np.float32), device=dev))


# (B, frames): the tick's headline, a tick of 32 streams, the session's
# chunk, mel_full of 60 s; the ticks at right context 1, 6 and 13 (16 / 56
# / 112 new frames per stream) and the session's chunk at 13; one offline
# segment (16,376 frames)
MEL_SHAPES = [(256, 8), (32, 8), (1, 8), (1, 6000), (256, 16), (256, 56),
              (256, 112), (1, 112), (1, 16376)]


@pytest.mark.parametrize("b, n_frames", MEL_SHAPES)
def test_mel_kernel_matches_plain(cuda, b, n_frames):
    """B2 against its plain version at the shapes its paths run, one launch
    per call; 1e-3 absolute on log-mel (the JAX suite's bound between its
    two mel paths)."""
    buf, win, fb = _mel_case(cuda, b, n_frames)
    before = kernels.MEL_FRAMES.launches
    got = mel_frames(buf, win, fb, n_frames)
    torch.cuda.synchronize()
    assert kernels.MEL_FRAMES.launches == before + 1
    torch.testing.assert_close(got, mel_frames_ref(buf, win, fb, n_frames),
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("fb_kind", ["dense", "slaney"])
@pytest.mark.parametrize("b, n_frames", [(256, 16), (256, 56), (256, 112),
                                         (1, 112)])
def test_mel_kernel_at_right_context_frames(cuda, b, n_frames, fb_kind):
    """B2 at the frame counts of the right-context ticks, on the plan
    mel_plan gives them: within 1e-4 of the exact float64 log-mel and
    1e-3 of the plain version, one launch per call."""
    buf, win, fb = _mel_case(cuda, b, n_frames, fb_kind=fb_kind, seed=b)
    before = kernels.MEL_FRAMES.launches
    got = mel_frames(buf, win, fb, n_frames)
    torch.cuda.synchronize()
    assert kernels.MEL_FRAMES.launches == before + 1
    assert got.shape == (b, n_frames, 128)
    torch.testing.assert_close(
        got, mel_exact(torch, buf, win, fb, n_frames).float(), atol=1e-4,
        rtol=0)
    torch.testing.assert_close(got, mel_frames_ref(buf, win, fb, n_frames),
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("signal", ["noise", "tone", "silence"])
@pytest.mark.parametrize("n_mels", [32, 80, 128])
@pytest.mark.parametrize("fb_kind", ["dense", "slaney"])
def test_mel_kernel_inputs_and_filterbanks(cuda, signal, n_mels, fb_kind):
    """B2 on white noise, on loud band-limited audio (bands just above the
    guard beside bins 1e4 times louder) and on silence (log(2^-24) exactly
    on both sides), at every filterbank height the wrapper takes, dense and
    slaney. The kernel's FFT is float64, so it is held to the exact
    log-mel at 1e-4 everywhere, and to the plain version at 1e-3 (the JAX
    suite's bound between its two mel paths) except on the tone through a
    slaney filterbank: there the plain version's f32 DFT-matmul is itself
    up to 2.5e-3 from the exact value (PERF.md section 6), so no
    implementation can be within 1e-3 of it and of the exact value both."""
    buf, win, fb = _mel_case(cuda, 32, 8, n_mels, fb_kind, signal)
    got = mel_frames(buf, win, fb, 8)
    want = mel_frames_ref(buf, win, fb, 8)
    assert got.shape == (32, 8, n_mels)
    torch.testing.assert_close(got.double(), mel_exact(torch, buf, win, fb, 8),
                               atol=1e-4, rtol=0)
    if (signal, fb_kind) != ("tone", "slaney"):
        torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    if signal == "silence":
        floor = torch.full_like(got, float(np.log(np.float32(2.0 ** -24))))
        torch.testing.assert_close(got, floor, atol=0, rtol=0)
        torch.testing.assert_close(want, floor, atol=0, rtol=0)


def test_mel_full_of_silence_on_the_card(cuda):
    """The frontend's zero centre padding and digital silence through B2
    (mel_full on the card) give log(2^-24) in every frame, as on the CPU."""
    fb = slaney_filterbank(128)
    win = np.hanning(400).astype(np.float32)
    audio = np.zeros(16000, np.int16)
    got = mel_full(audio, torch.tensor(fb, device=cuda), win)
    want = mel_full(audio, torch.tensor(fb), win)
    assert got.shape == want.shape and got.shape[1] == 128
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.full_like(got, np.log(np.float32(2.0 ** -24))))


def test_mel_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    buf, win, fb = _mel_case(cuda, 4, 8)
    flat = torch.zeros(buf.numel() + 1, device=cuda)
    shifted = flat[1:].view(buf.shape)  # contiguous, 4 bytes off 16
    with pytest.raises(ValueError):
        mel_frames(shifted, win, fb, 8)
    odd = torch.zeros(4, buf.shape[1] + 1, device=cuda)  # rows % 4 != 0
    with pytest.raises(ValueError):
        mel_frames(odd, win, fb, 8)
    with pytest.raises(ValueError):  # four samples short of 8 frames
        mel_frames(buf[:, :-4].contiguous(), win, fb, 8)
    w_flat = torch.zeros(513, device=cuda)
    with pytest.raises(ValueError):  # window 4 bytes off 16
        mel_frames(buf, w_flat[1:], fb, 8)
    with pytest.raises(ValueError):  # a filterbank height not compiled for
        mel_frames(buf, win, torch.ones(64, 257, device=cuda), 8)
    before = kernels.MEL_FRAMES.launches
    mel_frames(buf, win, fb, 8)
    assert kernels.MEL_FRAMES.launches == before + 1


def _block_inputs(dev, dtype, B=32, H=8, S=78, Dh=128, seed=0, D=None):
    """Kernel B3's inputs at the main path's shape: random validity windows
    (dead slots at -1e9 in the mask, 0 in pp), the new frame live. D (the
    model width) defaults to H * Dh; a tp shard's heads give less."""
    rng = np.random.default_rng(seed)
    D = D or H * Dh
    E = H * Dh

    def t(*shape, scale=1.0, dt=dtype):
        return torch.tensor((rng.standard_normal(shape) * scale).astype(
            np.float32), device=dev).to(dt)

    live = np.zeros((B, S + 1), bool)
    for b in range(B):
        lo = (b * 7) % S
        live[b, lo:S] = True
    live[:, S] = True
    mask = torch.tensor(np.where(live, 0.0, -1e9).astype(np.float32),
                        device=dev).to(dtype)
    pp = t(H, Dh, S + 1, scale=0.5, dt=torch.float32)
    w = [t(E, D, scale=D ** -0.5) for _ in range(3)] + [
        t(D, E, scale=E ** -0.5)]
    return dict(x=t(B, D), ln_w=1 + t(D, scale=0.1), ln_b=t(D, scale=0.1),
                q_w=w[0], k_w=w[1], v_w=w[2], out_w=w[3],
                bias_u=t(H, Dh, scale=0.1), bias_v=t(H, Dh, scale=0.1),
                pp=pp, mask=mask, k_buf=t(B, H, S, Dh), v_buf=t(B, H, S, Dh),
                n_heads=H, d_head=Dh)


@pytest.mark.parametrize("b", [7, 32, 141, 256])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype, rel", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_t1_attention_block_kernel_matches_plain(cuda, dtype, rel, int8, b):
    """B3 against its plain version, dense and int8 caches (garbage codes
    and scales in the dead slots); f32 within 1e-5 x max|out|, bf16 within
    1e-2 x max|out| (the bf16 rule of B4/B5); two calls give identical bits
    (the QKV splits are added in a fixed order)."""
    a = _block_inputs(cuda, dtype, B=b)
    if int8:
        a["k_buf"], a["v_buf"] = _int8_caches(a["k_buf"], a["v_buf"])
    before = kernels.T1_ATTENTION_BLOCK.launches
    got = t1_attention_block(**a)
    again = t1_attention_block(**a)
    torch.cuda.synchronize()
    assert kernels.T1_ATTENTION_BLOCK.launches == before + 2
    for g, w in zip(again, got):
        assert torch.equal(g, w)
    want = t1_attention_block_ref(**a)
    for name, g, w in zip(("out", "k_new", "v_new"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        err = float((g.float() - w.float()).abs().max())
        assert err <= rel * float(w.float().abs().max()), (name, err)
    if int8:  # other garbage in stream 3's dead slots changes nothing
        a["v_buf"].q[3, :, :21] = -5
        a["k_buf"].s[3, :, :21] = -7.0
        for g, w in zip(t1_attention_block(**a), got):
            torch.testing.assert_close(g, w, atol=0, rtol=0)


def _largest_attention_s_buf(elem, splits, sms, b=64, h=8, d_head=128):
    """The S_buf at which B3's attention plan (ops/attn_block.py:
    attn_group) gives its block the most shared memory, by attn_smem;
    `splits` is the QKV splits, or None for the f32 plan's at each S_buf."""
    from nemotron_tpu_torch.ops.attn_block import (attn_group, attn_smem,
                                                   block_f32_plans)

    best = (0, 0)
    for s in range(2, 256):
        z = splits or block_f32_plans(b, h * d_head, s, d_head, elem,
                                      sms)[0].splits
        try:
            p = attn_group(b, h, s, d_head, elem, z, sms)
        except ValueError:
            continue
        best = max(best, (attn_smem(s, d_head, elem, p.stages, z,
                                    p.groups), s))
    return best[1]


@pytest.mark.parametrize("case", ["qkv bf16 D=2048", "attention f32",
                                  "attention bf16", "attention bf16 int8"])
def test_t1_attention_block_at_the_plans_largest_shared_memory(cuda, case):
    """The plans' Python copies of the kernels' shared-memory layouts
    (dense_smem for the QKV projection's batch tile, attn_smem for the
    attention launch's groups and stages) at the configurations where they
    come closest to one block's limit: B3 launches and agrees with its
    plain version, so neither copy is smaller than the kernel's own."""
    from nemotron_tpu_torch.ops.attn_block import block_gemm_plans, dense_smem
    from nemotron_tpu_torch.ops.attn_kernel import SMEM_BLOCK, sm_count

    sms = sm_count(cuda)
    dtype = torch.float32 if "f32" in case else torch.bfloat16
    int8 = "int8" in case
    if case.startswith("qkv"):  # the resident LN rows beside two stages
        B, H, S = 96, 16, 78
        qkv, _ = block_gemm_plans(B, H * 128, sms)
        assert SMEM_BLOCK - dense_smem(True, qkv.nt, qkv.steps, 2) < 2048
    else:
        B, H = 64, 8
        splits = None if dtype == torch.float32 else block_gemm_plans(
            B, H * 128, sms)[0].splits
        S = _largest_attention_s_buf(1 if int8 else dtype.itemsize, splits,
                                     sms, b=B, h=H)
    a = _block_inputs(cuda, dtype, B=B, H=H, S=S)
    if int8:
        a["k_buf"], a["v_buf"] = _int8_caches(a["k_buf"], a["v_buf"])
    got = t1_attention_block(**a)
    want = t1_attention_block_ref(**a)
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    for name, g, w in zip(("out", "k_new", "v_new"), got, want):
        err = float((g.float() - w.float()).abs().max())
        assert err <= rel * float(w.float().abs().max()), (name, S, err)


@pytest.mark.parametrize("b", [1, 8, 256])
@pytest.mark.parametrize("int8", [False, True])
def test_t1_attention_block_f32_splits_qkv(cuda, int8, b):
    """B3 in f32 with its projections split along K (ops/attn_block.py:
    block_f32_plans: the QKV splits added by the attention launch, the out
    splits by the tile's last block) against its plain version within
    1e-5 x max|out|; two calls give identical bits."""
    from nemotron_tpu_torch.ops.attn_block import block_f32_plans
    from nemotron_tpu_torch.ops.attn_kernel import sm_count

    a = _block_inputs(cuda, torch.float32, B=b, seed=b)
    if int8:
        a["k_buf"], a["v_buf"] = _int8_caches(a["k_buf"], a["v_buf"])
    qkv, out = block_f32_plans(b, 1024, 78, 128, 1 if int8 else 4,
                               sm_count(cuda))
    assert qkv.splits > 1 and out.splits > 1
    got = t1_attention_block(**a)
    again = t1_attention_block(**a)
    torch.cuda.synchronize()
    want = t1_attention_block_ref(**a)
    for name, g, r, w in zip(("out", "k_new", "v_new"), got, again, want):
        assert torch.equal(g, r), name
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err)


def test_t1_attention_block_wrapper_refuses(cuda):
    a = _block_inputs(cuda, torch.float32, B=4)
    with pytest.raises(ValueError):  # pp must be f32
        t1_attention_block(**{**a, "pp": a["pp"].double()})
    with pytest.raises(ValueError):  # weights in another type than x
        t1_attention_block(**{**a, "q_w": a["q_w"].bfloat16()})
    with pytest.raises(ValueError):  # d_model != n_heads * d_head
        t1_attention_block(**{**a, "n_heads": 4})


@pytest.mark.parametrize("block", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_tiny_tick_on_card_matches_cpu(cuda, int8, block):
    """Dense, or int8 K/V caches (codes within +-1) with Q8_0 weights
    (dense ones with the attention block, which takes them dense); through
    B1, or through B3 with `block`."""
    _tiny_tick_on_card_matches_cpu(cuda, int8, block, 0)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mode", [1, 6, 13])
def test_tiny_tick_at_right_context_on_card_matches_cpu(cuda, mode, int8):
    """Right context 1 / 6 / 13 (chunk_len 2 / 7 / 14; attention as
    torch.matmul, B1 and B3 not launched), dense or int8 K/V with Q8_0
    weights (B4 at M = 3 x chunk_len), through a wrap."""
    _tiny_tick_on_card_matches_cpu(cuda, int8, False, mode)


def _tiny_tick_on_card_matches_cpu(cuda, int8, block, mode):
    hp = Hparams(n_mels=32, d_model=64, n_heads=4, d_head=16, d_ff=96,
                 n_layers=2, kernel_size=5, vocab_size=33, decoder_dim=32,
                 joint_dim=32, subsampling_channels=16, att_left_context=8,
                 max_pos_len=64)
    q8 = int8 and not block
    cpu = ASRModel.random(hp, seed=1, device="cpu", kv_int8=int8,
                          attn_block=block)
    if q8:
        cpu.params = quantize_encoder_layers(cpu.params)
    gpu = ASRModel(hp, params_to(cpu.params, cuda), cpu.tokenizer.vocab,
                   device=cuda, kv_int8=int8, attn_block=block)
    cfg = cpu.cache_config(mode)
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
    n = hp.n_layers * (i + 1)
    n_t1 = 0 if mode else n  # at T > 1 the attention is torch.matmul
    assert kernels.MEL_FRAMES.launches == i + 1
    assert kernels.T1_ATTENTION.launches == (0 if block else n_t1)
    assert kernels.T1_ATTENTION_BLOCK.launches == (n_t1 if block else 0)
    assert kernels.Q8_MATMUL.launches == (11 * n if q8 else 0)
    for name in ("k_cache", "v_cache", "conv_cache", "pp_tail", "mel_ov"):
        got, want = getattr(states[1], name), getattr(states[0], name)
        if isinstance(want, QuantKV):
            torch.testing.assert_close(got.q.cpu().float(), want.q.float(),
                                       atol=1, rtol=0)
            got, want = got.s, want.s
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("q8", [False, True])
def test_tiny_offline_batch_on_card_matches_cpu(cuda, q8):
    """The offline path at the tiny geometry (a segment cap of ~500 mel
    frames), three files in one ragged batch, one past the cap: encode_batch
    within 1e-4 of the CPU's, texts equal to the CPU's and to the card's
    per-file runs; B2 once per transcribe_audios call, B4 11 x n_layers per
    segment with Q8_0 weights, B1 and B3 never."""
    from nemotron_tpu_torch.models.encoder import encode_batch

    hp = Hparams(n_mels=32, d_model=64, n_heads=4, d_head=16, d_ff=96,
                 n_layers=2, kernel_size=5, vocab_size=33, decoder_dim=32,
                 joint_dim=32, subsampling_channels=16, att_left_context=8,
                 max_pos_len=64)
    cpu = ASRModel.random(hp, seed=1, device="cpu")
    if q8:
        cpu.params = quantize_encoder_layers(cpu.params)
    gpu = ASRModel(hp, params_to(cpu.params, cuda), cpu.tokenizer.vocab,
                   device=cuda)
    rng = np.random.default_rng(4)
    audios = [(rng.standard_normal(n) * 3000).astype(np.int16)
              for n in (7000, 96000, 12800)]
    lengths = (83, 41, 64)
    mel = rng.standard_normal((3, 96, hp.n_mels)).astype(np.float32)
    n_mel = np.asarray(lengths, np.int32)
    n_sub = np.asarray([hp.subsampled_len(n) for n in lengths], np.int32)
    encs = [encode_batch(m.params, hp, m.put_batch(mel),
                         n_frames=m.put_batch(n_sub),
                         n_mel_frames=m.put_batch(n_mel)).cpu()
            for m in (cpu, gpu)]
    for i, n in enumerate(n_sub):
        torch.testing.assert_close(encs[1][i, :n], encs[0][i, :n],
                                   atol=1e-4, rtol=0)
    want = cpu.transcribe_audios(audios, timestamp_words=True)
    kernels.reset_counts()
    got = gpu.transcribe_audios(audios, timestamp_words=True)
    torch.cuda.synchronize()
    segments = len(gpu.offline_stats)
    assert segments == 2
    assert got == want and all(want)
    assert kernels.MEL_FRAMES.launches == 1
    assert kernels.Q8_MATMUL.launches == (11 * hp.n_layers * segments
                                          if q8 else 0)
    assert kernels.T1_ATTENTION.launches == 0
    assert kernels.T1_ATTENTION_BLOCK.launches == 0
    assert [gpu.transcribe_audio(a, timestamp_words=True)
            for a in audios] == want


def _tiny_hp():
    return Hparams(n_mels=32, d_model=64, n_heads=4, d_head=16, d_ff=96,
                   n_layers=2, kernel_size=5, vocab_size=33, decoder_dim=32,
                   joint_dim=32, subsampling_channels=16, att_left_context=8,
                   max_pos_len=64)


@pytest.mark.parametrize("form", ["f32", "bf16", "int8-kv"])
def test_extract_install_slot_round_trips_on_the_card(cuda, form):
    """extract_slot copies a slot of a state on the card to numpy leaves
    and install_slot writes it into another slot: every leaf bit-exact,
    the other slots untouched."""
    from nemotron_tpu_torch.streaming.state import (extract_slot,
                                                    install_slot,
                                                    state_leaves)

    model = ASRModel.random(
        _tiny_hp(), seed=1, device=cuda, kv_int8=form == "int8-kv",
        dtype=torch.bfloat16 if form == "bf16" else torch.float32)
    state = model.init_stream_state(4, model.cache_config(0))
    gen = torch.Generator(device=cuda).manual_seed(3)
    for t in state_leaves(state):  # random contents, every leaf's type
        t.copy_(torch.randint(-100, 100, t.shape, generator=gen,
                              device=cuda).to(t.dtype) / (
            7 if t.is_floating_point() else 1))
    before = [t.clone() for t in state_leaves(state)]
    snap = extract_slot(state, 1)
    install_slot(state, 3, snap)
    for n, (t, b) in enumerate(zip(state_leaves(state), before)):
        ax = 1 if n < len(before) - 8 else 0  # the caches at axis 1
        assert torch.equal(t.select(ax, 3), b.select(ax, 1)), n
        for r in (0, 1, 2):
            assert torch.equal(t.select(ax, r), b.select(ax, r)), n


@pytest.mark.parametrize("int8", [False, True])
def test_tiny_stream_migrates_on_the_card(cuda, int8):
    """A tiny stream exported mid-flight from one engine on the card and
    imported, through the snapshot bytes, into another at a different
    phase gives the transcript of an unmigrated run on the card."""
    from nemotron_tpu_torch.streaming.engine import (BatchedEngine,
                                                     snapshot_from_bytes,
                                                     snapshot_to_bytes)

    model = ASRModel.random(_tiny_hp(), seed=1, device=cuda, kv_int8=int8)
    rng = np.random.default_rng(5)
    audio = (rng.standard_normal(12800) * 3000).astype(np.int16)

    def own(events, sid):
        return "".join(e.text for e in events if e.stream_id == sid)

    def run(engine, sid, lo, hi, text):
        for off in range(lo, hi, 1600):
            engine.push_audio(sid, audio[off:min(off + 1600, hi)])
            text += own(engine.tick()[0], sid)
        return text

    def finish(engine, sid, text):
        engine.end_stream(sid)
        for _ in range(100):
            events, more = engine.tick()
            text += own(events, sid)
            if not more:
                return text
        raise AssertionError("engine did not go idle")

    plain = BatchedEngine(model, 2)
    sid = plain.start_stream(0)
    want = finish(plain, sid, run(plain, sid, 0, len(audio), ""))
    a, b = BatchedEngine(model, 2), BatchedEngine(model, 2)
    decoy = b.start_stream(0)
    run(b, decoy, 0, 3200, "")  # b at another phase
    sid = a.start_stream(0)
    text = run(a, sid, 0, 4800, "")
    fut = a.request_export(sid)
    text += own(a.tick()[0], sid)
    snap = snapshot_from_bytes(snapshot_to_bytes(fut.result(timeout=30)),
                               model)
    assert snap["phase"] != b.groups[0].phase
    fut = b.request_import(snap)
    events = b.tick()[0]
    sid2 = fut.result(timeout=30)
    text += own(events, sid2)
    text = finish(b, sid2, run(b, sid2, 4800, len(audio), text))
    assert want and text == want


def test_diarize_nets_on_card_match_cpu(cuda, tmp_path):
    """MarbleNet and TitaNet-L at the published widths (the random diarize
    GGUF of chip_smoke.write_random_diarize_gguf) on the card against the
    CPU in f32, over full and ragged lengths: VAD within 1e-4, embeddings
    within 1e-3 of max(1, max|e|)."""
    from chip_smoke import diarize_signal, write_random_diarize_gguf
    from nemotron_tpu_torch.diarize.nets import spk_embed, vad_probs
    from nemotron_tpu_torch.diarize.params import load_diarize_model

    path = str(tmp_path / "diarize.gguf")
    write_random_diarize_gguf(path)
    gpu = load_diarize_model(path, device="cuda")
    cpu = load_diarize_model(path, device="cpu")
    sig = diarize_signal()
    for net, name, n, count, rule in ((vad_probs, "vad", 10080, 16, 1e-4),
                                      (spk_embed, "spk", 24000, 4, 1e-3)):
        w = np.stack([sig[i * 16000:i * 16000 + n] for i in range(count)])
        lens = np.full(count, n, np.int32)
        lens[1::2] = n * 2 // 3
        for i in range(count):
            w[i, lens[i]:] = 0.0
        want = net(getattr(cpu, name), torch.from_numpy(w),
                   torch.from_numpy(lens)).numpy()
        got = net(getattr(gpu, name), torch.from_numpy(w).cuda(),
                  torch.from_numpy(lens).cuda()).cpu().numpy()
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err <= rule, (name, err)


def test_native_server_texts_on_card(cuda):
    """The native ingest server on the card: two clients' texts equal the
    asyncio server's and the card's StreamSession's (a tiny random model)."""
    import asyncio
    import threading

    from nemotron_tpu_torch.serving.client import transcribe_file
    from nemotron_tpu_torch.serving.native_server import NativeStreamServer
    from nemotron_tpu_torch.serving.server import StreamServer
    from nemotron_tpu_torch.streaming.session import StreamSession

    model = ASRModel.random(_tiny_hp(), seed=1, device="cuda")
    rng = np.random.default_rng(2)
    t = np.arange(9600) / 16000.0
    audios = [(np.clip(0.4 * np.sin(2 * np.pi * f * t)
                       + 0.2 * rng.standard_normal(len(t)), -1, 1)
               * 32767).astype(np.int16) for f in (260.0, 410.0)]
    want = []
    for a in audios:
        s = StreamSession(model, 0)
        s.process_incremental(a)
        s.finalize()
        want.append(s.get_transcript())

    def clients(port):
        async def run():
            return await asyncio.gather(*[
                transcribe_file(a, host="127.0.0.1", port=port, chunk_ms=100)
                for a in audios])
        return asyncio.run(run())

    srv = NativeStreamServer(model, batch_per_group=4)
    port = srv.start("127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        native = clients(port)
    finally:
        srv.stop()
        th.join(timeout=30)

    async def plain():
        s = StreamServer(model, batch_per_group=4)
        server = await s.start("127.0.0.1", 0)
        try:
            return await asyncio.to_thread(
                clients, server.sockets[0].getsockname()[1])
        finally:
            await s.stop(server)

    assert native == asyncio.run(plain()) == want and all(want)


# the tp shards' heads of the full-width model (H = 8, Dh = 128, D = 1024):
# tp = 2 and tp = 4 (parallel/mesh.py)
TP_HEADS = (4, 2)


@pytest.mark.parametrize("b", [32, 256])
@pytest.mark.parametrize("h_l", TP_HEADS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype, rel", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_t1_attention_block_at_tp_heads(cuda, dtype, rel, int8, h_l, b):
    """B3 as a tp shard runs it: H_l heads of D = 1024 (projections [H_l *
    Dh, D], out projection [D, H_l * Dh]), the residual left out, against
    its plain version with the rule of the unsharded test."""
    a = _block_inputs(cuda, dtype, B=b, H=h_l, D=1024, seed=h_l)
    if int8:
        a["k_buf"], a["v_buf"] = _int8_caches(a["k_buf"], a["v_buf"])
    before = kernels.T1_ATTENTION_BLOCK.launches
    got = t1_attention_block(**a, residual=False)
    torch.cuda.synchronize()
    assert kernels.T1_ATTENTION_BLOCK.launches == before + 1
    want = t1_attention_block_ref(**a, residual=False)
    for name, g, w in zip(("out", "k_new", "v_new"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        err = float((g.float() - w.float()).abs().max())
        assert err <= rel * float(w.float().abs().max()), (name, err)
    # the residual switch only drops x: with it, out is x + the partial
    # (in bf16 rounded once from f32, not twice: within a bf16 ulp)
    with_res = t1_attention_block(**a)[0].float()
    err = float((with_res - (a["x"].float() + got[0].float())).abs().max())
    tol = rel if dtype == torch.float32 else 2.0 ** -7
    assert err <= tol * float(with_res.abs().max()), err


# the encoder's (N, K) at tp = 2 and tp = 4 (q / k / v / pos and ffn w1
# split N, ffn w2 and attn_out split K): the full weight's (N, K), the axis
# split, the shards
TP_GEMM_SPLITS = [(1024, 1024, 1, 2), (4096, 1024, 1, 2), (1024, 4096, 2, 2),
                  (1024, 1024, 2, 2), (1024, 1024, 1, 4), (1024, 4096, 2, 4)]


@pytest.mark.parametrize("m", [256, 256 * 14])
@pytest.mark.parametrize("split", TP_GEMM_SPLITS)
@pytest.mark.parametrize("dtype, rel", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_linears_at_tp_shapes(cuda, bits, dtype, rel, split, m):
    """B4 / B5 on a tp shard's slice of a full-width weight (params.tp_slice:
    the Q4_0 nibbles re-packed per K slice) at a B=256 tick's rows at right
    contexts 0 and 13, against the plain version."""
    from nemotron_tpu_torch.params import tp_slice

    full_n, full_k, axis, n_tp = split
    rng = np.random.default_rng(full_n + full_k + axis + n_tp + bits)
    w = (rng.standard_normal((1, full_n, full_k)) / np.sqrt(full_k)
         ).astype(np.float32)
    qt = (quant.quantize_q8 if bits == 8 else quant.quantize_q4)(w)
    part = tp_slice(qt, axis, n_tp, n_tp - 1)[0].to(cuda)
    n = full_n // n_tp if axis == 1 else full_n
    k = full_k // n_tp if axis == 2 else full_k
    x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32),
                     device=cuda).to(dtype)
    fn, ref = ((quant.linear_q8, quant.linear_q8_ref) if bits == 8
               else (quant.linear_q4, quant.linear_q4_ref))
    got = fn(x, part)
    assert got.shape == (m, n)
    want = ref(x, part).float()
    err = float((got.float() - want).abs().max())
    assert err <= rel * float(want.abs().max()), err


# --- the compiled tick (graphs.py): graphed against eager at full width ---

GRAPH_FORMS = ("f32", "bf16-block", "bf16-q8-int8kv")
GRAPH_B = 32
BLANK_BIAS = 2.4  # random full-width weights then emit ~2 tokens a frame


def _graph_pair(form):
    """(graphed, eager) full-width models on the same random weights."""
    dtype = torch.bfloat16 if form.startswith("bf16") else torch.float32
    graphed = ASRModel.random(Hparams(), seed=0, dtype=dtype, device="cuda",
                              kv_int8="int8kv" in form,
                              attn_block="block" in form)
    graphed.params.joint.out_b[graphed.hp.blank_id] += BLANK_BIAS
    if "q8" in form:
        graphed.params = quantize_encoder_layers(graphed.params, bits=8)
    eager = ASRModel(graphed.hp, graphed.params, graphed.tokenizer.vocab,
                     device="cuda", kv_int8=graphed.kv_int8,
                     attn_block=graphed.attn_block, graphs=False)
    return graphed, eager


def _launches():
    return {k.name: k.launches for k in kernels.KERNELS}


@pytest.mark.parametrize("form", GRAPH_FORMS)
def test_graphed_ticks_equal_eager_at_full_width(cuda, form):
    """tools/graph_turns.run_schedule (wraps, the backlog, a masked tick,
    a join; three passes: warm-up, capture, replay) at B=32, R=0 on both
    models: tokens equal, every leaf bit-equal (f32: the largest
    difference printed, within 1e-6), one capture per key (the ticks' and
    the slot operations'), the last pass (uploads, replays, slot
    operations) under set_sync_debug_mode("error"), and the kernels'
    launch counts through the replays equal to eager's."""
    from nemotron_tpu_torch.tools.graph_turns import compare, run_schedule

    graphed, eager = _graph_pair(form)
    kernels.reset_counts()
    tok_e, st_e = run_schedule(eager, GRAPH_B)
    n_eager = _launches()
    kernels.reset_counts()
    tok_g, st_g = run_schedule(graphed, GRAPH_B, sync_debug=True)
    n_graphed = _launches()
    cmp = compare(st_g, st_e)
    stats = graphed.graphs.stats()
    print(f"{form}: {cmp}, graphs {stats}, launches {n_graphed}")
    assert len(tok_g) == len(tok_e)
    assert all(np.array_equal(g, e) for g, e in zip(tok_g, tok_e))
    assert sum(int((t >= 0).sum()) for t in tok_g) > 0
    if form == "f32":
        assert cmp["max_abs"] <= 1e-6, cmp
    else:
        assert cmp["equal"], cmp
    ticks = graphed.graphs.stats(lambda key: key[0] == "tick_packed")
    assert ticks["captures"] == ticks["keys"] == 11, ticks
    # with the four slot operations' keys (prime, reset, wrap, realign)
    assert stats["captures"] == stats["keys"] == 15, stats
    assert stats["recaptures"] == 0 and stats["replays"] > stats["captures"]
    assert n_graphed == n_eager
    assert n_graphed["mel_frames"] > 0 and n_graphed["kv_rows"] > 0


def test_graphed_stream_step_and_profiled_halves_equal_eager(cuda):
    """stream_step and the two halves of fused_tick_profiled at B=32 in
    f32, three calls each (warm-up, capture, replay): outputs and states
    bit-equal to the eager model's, one capture per key."""
    graphed, eager = _graph_pair("f32")
    hp, cfg = graphed.hp, graphed.cache_config(0)
    rng = np.random.default_rng(5)
    states = [m.init_stream_state(GRAPH_B, cfg) for m in (graphed, eager)]
    for _ in range(3):
        mel = rng.standard_normal((GRAPH_B, cfg.chunk_mel_frames, hp.n_mels))
        outs = [m.stream_step(cfg, s, m.put_batch(mel.astype(np.float32)),
                              m.put_batch(np.full(GRAPH_B, 1, np.int32)),
                              None)[1].cpu()
                for m, s in zip((graphed, eager), states)]
        assert torch.equal(*outs)
        audio = (rng.standard_normal((GRAPH_B, cfg.shift_samples)) * 3000
                 ).astype(np.int16)
        outs = [m.fused_tick_profiled(
            cfg, s, m.put_batch(audio), m.put_batch(
                np.full(GRAPH_B, 1, np.int32)), None)[1].cpu()
            for m, s in zip((graphed, eager), states)]
        assert torch.equal(*outs)
    from nemotron_tpu_torch.tools.graph_turns import compare

    assert compare(*states)["equal"]
    stats = graphed.graphs.stats()
    assert stats["keys"] == stats["captures"] == 3 and stats["replays"] == 6


def test_graph_recaptures_a_state_with_other_storage(cuda):
    """Two states of one key in turns from its first capture on (as two
    engines of one model, or an engine and a migration's target): each
    change of storage captures the key again (counted), the pool keeps a
    graph throughout, and every tick equals the eager model's."""
    graphed = ASRModel.random(_tiny_hp(), seed=1, device=cuda)
    eager = ASRModel(graphed.hp, graphed.params, graphed.tokenizer.vocab,
                     device=cuda, graphs=False)
    cfg = graphed.cache_config(0)
    rng = np.random.default_rng(3)
    states = {m: [m.init_stream_state(2, cfg) for _ in range(2)]
              for m in (graphed, eager)}
    for i, which in enumerate((0, 0, 1, 0, 1, 1)):
        audio = (rng.standard_normal((2, cfg.shift_samples)) * 3000
                 ).astype(np.int16)
        toks = []
        for m in (graphed, eager):
            packed = m.put_batch(m.pack_tick_inputs(
                audio, np.full(2, cfg.valid_out_len), np.zeros(2), None))
            _, t = m.fused_tick_packed(cfg, states[m][which], packed, True)
            toks.append(t.cpu())
        assert torch.equal(*toks), i
    stats = graphed.graphs.stats()
    assert stats["keys"] == 1 and stats["recaptures"] == 3
    assert stats["captures"] == 4 and stats["replays"] == 5


def test_capture_survives_a_collected_graph(cuda):
    """A graph cache left in a reference cycle (a dropped model's) is
    freed by the cyclic collector, which may start at any allocation, and
    so in the middle of another key's capture on the same thread, where a
    graph's destruction invalidates the capture. Here the cycle becomes
    garbage inside the capture, and the body then asks for a collection at
    the next allocation: the capture still succeeds (the collector is
    paused), and the replay is right."""
    import gc

    from nemotron_tpu_torch.graphs import GraphCache

    x = torch.arange(4096, dtype=torch.float32, device=cuda)
    doomed = []

    def body(_state, a):
        if doomed:  # the capture's call
            doomed.clear()  # the old cache's last reference: garbage now
            gc.set_threshold(1)  # a collection at the next allocation
        junk = [[] for _ in range(64)]  # noqa: F841
        return (a * 2.0 + 1.0,)

    threshold = gc.get_threshold()
    gc.collect()
    gc.set_threshold(10 ** 6, 10 ** 6, 10 ** 6)  # none until the body's
    try:
        new = GraphCache()
        new.run(("k",), 0, cuda, body, (), (x,))  # the warm-up
        old = GraphCache()
        for _ in range(2):
            old.run(("old",), 0, cuda, lambda _s, a: (a - 1.0,), (), (x,))
        assert old.stats()["captures"] == 1
        old.cycle = old  # only the cyclic collector frees it
        doomed.append(old)
        del old
        for _ in range(2):
            out, = new.run(("k",), 0, cuda, body, (), (x,))
        torch.cuda.synchronize()
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    assert not doomed and torch.equal(out, x * 2.0 + 1.0)
    assert new.stats()["captures"] == 1 and new.stats()["replays"] == 2


OFFLINE_GRAPH_FORMS = ("f32", "bf16", "f32-q8", "f32-q4")


@pytest.mark.parametrize("form", OFFLINE_GRAPH_FORMS)
def test_graphed_offline_equals_eager(cuda, form):
    """The offline path over three files, one past the segment cap (two
    segments, both of one encoder key and one decode key), three times on
    the graphed model and once eagerly: token ids, frames and texts equal,
    the final decoder state bit-equal, each key captured once and replayed
    after, and the third call's launches through the replays equal to the
    eager call's (B4 or B5 once per quantized matrix per segment). The
    eager model keeps no decode carry."""
    dtype = torch.bfloat16 if form == "bf16" else torch.float32
    graphed = ASRModel.random(_tiny_hp(), seed=1, dtype=dtype, device=cuda)
    if "q" in form:
        graphed.params = quantize_encoder_layers(graphed.params,
                                                 bits=int(form[-1]))
    eager = ASRModel(graphed.hp, graphed.params, graphed.tokenizer.vocab,
                     device=cuda, graphs=False)
    rng = np.random.default_rng(4)
    audios = [(rng.standard_normal(n) * 3000).astype(np.int16)
              for n in (7000, 96000, 12800)]
    mels = process_many([eager._preprocessor() for _ in audios], audios)
    kernels.reset_counts()
    want, want_state = eager._transcribe_mels(mels, None)
    torch.cuda.synchronize()
    n_eager = _launches()
    assert not eager._carries
    for call in ("warm-up", "capture", "replay"):
        kernels.reset_counts()
        got, state = graphed._transcribe_mels(mels, None)
        torch.cuda.synchronize()
        assert got == want and all(ids for ids, _ in want), call
        for f in ("h", "c", "prev_token", "frame_offset"):
            assert torch.equal(getattr(state, f),
                               getattr(want_state, f)), (call, f)
        enc = [how for s in graphed.offline_stats
               for key, how in s["graphs"].items() if key[0] == "batch"]
        assert len(enc) == 2
    assert enc == [{"calls": 1, "captures": 0, "replays": 1}] * 2
    assert _launches() == n_eager
    assert (graphed.transcribe_audios(audios, timestamp_words=True)
            == eager.transcribe_audios(audios, timestamp_words=True))
    # the quantized matrices (Q4_0 leaves d_ff = 96 dense), per segment
    n_q = 2 * graphed.hp.n_layers * sum(
        quant.is_quantized(getattr(graphed.params.layers, f))
        for f in QUANT_LAYER_FIELDS)
    assert n_eager["q8_matmul"] == (n_q if form == "f32-q8" else 0)
    assert n_eager["q4_matmul"] == (n_q if form == "f32-q4" else 0)
    stats = graphed.graphs.stats()
    # both segments pad to the cap: one encoder key, one decode key
    assert stats["keys"] == stats["captures"] == 2, stats
    assert stats["recaptures"] == 0 and stats["replays"] > 6
    graphed.drop_offline_graphs()
    assert not graphed.graphs.entries and not graphed.graphs._pools


def test_graphed_diarize_nets_equal_eager(cuda, tmp_path):
    """The diarize nets through DiarizePipeline._run at the published
    widths, graphed (one graph per net and bucket, three calls each) and
    eager: probabilities and embeddings bit-equal, one capture per key;
    the 30 s pipeline's segments and RTTM equal both ways."""
    from chip_smoke import (_pipeline_run, diarize_signal,
                            write_random_diarize_gguf)
    from nemotron_tpu_torch.diarize.params import load_diarize_model
    from nemotron_tpu_torch.diarize.pipeline import DiarizePipeline

    path = str(tmp_path / "diarize.gguf")
    write_random_diarize_gguf(path)
    models = [load_diarize_model(path, device=cuda) for _ in range(2)]
    models[1].graphs.enabled = False
    pipes = [DiarizePipeline(m) for m in models]
    sig = diarize_signal()
    for name, n, count in (("vad", 10080, 16), ("spk", 24000, 4)):
        w = np.stack([sig[i * 16000:i * 16000 + n] for i in range(count)])
        lens = np.full(count, n, np.int32)
        lens[1::2] = n * 2 // 3
        fn = "_vad_fn" if name == "vad" else "_spk_fn"
        for _ in range(3):
            got, want = (getattr(p, fn)(w, lens) for p in pipes)
            assert np.array_equal(got, want), name
    stats = models[0].graphs.stats()
    assert stats["keys"] == stats["captures"] == 2 and stats["replays"] == 4
    (pg, rg), (pe, re_) = (_pipeline_run(m, sig) for m in models)
    assert pg.segments == pe.segments and rg.rttm == re_.rttm
    assert pg.n_segments and models[0].graphs.stats()["recaptures"] == 0


# --- kv_rows: the slot operations' masked row rewrites ---------------------

from nemotron_tpu_torch.ops import kv_rows as kvr  # noqa: E402

# (L, B, H, S, Dh): full width at right context 0 (S_buf 78) and 6 / 13
# (98), a tp head shard (H = 4 of 8, and 2), and the tiny geometry
KV_ROWS_GEOMS = {"full-78": (2, 256, 8, 78, 128), "full-98": (2, 256, 8, 98,
                                                              128),
                 "tp4-78": (2, 256, 4, 78, 128), "tp2-98": (2, 64, 2, 98, 128),
                 "tiny": (2, 5, 4, 16, 16)}
KV_ROWS_KINDS = ("f32", "bf16", "int8 codes", "scales")
KV_ROWS_MASKS = ("none", "clear", "one", "some", "all")


def _kv_rows_buffer(dev, kind, geom, seed):
    n_l, b, h, s, dh = geom
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "int8 codes":
        return torch.randint(-127, 128, (n_l, b, h, s, dh), generator=g,
                             device=dev, dtype=torch.int8)
    shape = (n_l, b, h, s) if kind == "scales" else (n_l, b, h, s, dh)
    x = torch.randn(shape, generator=g, device=dev)
    return x.to(torch.bfloat16) if kind == "bf16" else x


def _kv_rows_mask(dev, which, b):
    m = {"none": None, "clear": np.zeros(b, bool),
         "one": np.arange(b) == b // 2, "some": np.arange(b) % 4 == 1,
         "all": np.ones(b, bool)}[which]
    return None if m is None else torch.tensor(m, device=dev)


@pytest.mark.parametrize("mask", KV_ROWS_MASKS)
@pytest.mark.parametrize("kind", KV_ROWS_KINDS)
@pytest.mark.parametrize("geom", list(KV_ROWS_GEOMS))
def test_kv_rows_kernel_matches_plain(cuda, geom, kind, mask):
    """kv_rows against its plain version, bit for bit, in each mode: the
    compaction's shift (the wrap and a mid-cycle phase), the realign's
    roll (forward and back) and the reset's zero; one launch each."""
    g = KV_ROWS_GEOMS[geom]
    s = g[3]
    lc = s - {78: 8, 98: 28, 16: 8}[s]  # the window; the slack behind it
    m = _kv_rows_mask(cuda, mask, g[1])
    calls = ((kvr.SHIFT, dict(lo=s - lc, lc=lc)),
             (kvr.SHIFT, dict(lo=3, lc=lc)),
             (kvr.ROLL, dict(shift=s - lc - 1)), (kvr.ROLL, dict(shift=-7)),
             (kvr.ZERO, {}))
    for i, (mode, kw) in enumerate(calls):
        buf = _kv_rows_buffer(cuda, kind, g, seed=i)
        want = kvr.kv_rows_ref_(buf.clone(), mode, m, **{
            k: (v % s if k == "shift" else v) for k, v in kw.items()})
        before = kernels.KV_ROWS.launches
        got = kvr.kv_rows_(buf, mode, m, **kw)
        torch.cuda.synchronize()
        assert got is buf and kernels.KV_ROWS.launches == before + 1
        assert torch.equal(buf, want), (mode, kw)


def test_kv_rows_wrapper_refuses(cuda):
    buf = torch.zeros((2, 4, 2, 16, 8), device=cuda)
    with pytest.raises(ValueError):
        kvr.kv_rows_(buf, kvr.SHIFT, lo=10, lc=8)  # past S
    with pytest.raises(ValueError):
        kvr.kv_rows_(buf.transpose(3, 4), kvr.ZERO)  # not contiguous
    with pytest.raises(ValueError):
        kvr.kv_rows_(buf, kvr.ZERO, torch.ones(3, dtype=torch.bool,
                                               device=cuda))


SLOT_FORMS = ("f32", "bf16-int8kv")


@pytest.mark.parametrize("form", SLOT_FORMS)
def test_graphed_slot_ops_equal_eager(cuda, form):
    """The slot operations between ticks (JAX's ("compact", cfg, phase,
    masked) and ("realign", cfg, delta), ("prime", cfg) and
    ("reset", cfg)) on a graphed and an eager model at full width, B=32, R=0,
    from the same random state, three rounds (warm-up, capture, replay)
    with other masks each round: every leaf bit-equal after each call,
    each key captured once and replayed, and the third round under
    set_sync_debug_mode("error")."""
    from nemotron_tpu_torch.streaming.state import state_leaves
    from nemotron_tpu_torch.tools.graph_turns import (compare,
                                                      slot_ops_sync_errors)

    dtype = torch.bfloat16 if form.startswith("bf16") else torch.float32
    graphed = ASRModel.random(Hparams(), seed=0, dtype=dtype, device=cuda,
                              kv_int8="int8kv" in form)
    eager = ASRModel(graphed.hp, graphed.params, graphed.tokenizer.vocab,
                     device=cuda, kv_int8=graphed.kv_int8, graphs=False)
    cfg = graphed.cache_config(0)
    states = [m.init_stream_state(GRAPH_B, cfg) for m in (graphed, eager)]
    g = torch.Generator(device=cuda).manual_seed(3)
    for a, b in zip(*(state_leaves(st) for st in states)):
        if a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=g,
                                  device=cuda, dtype=torch.int8))
        elif a.is_floating_point():
            a.copy_(torch.randn(a.shape, generator=g, device=cuda))
        b.copy_(a)
    rng = np.random.default_rng(6)
    for rnd in range(3):
        masks = [rng.random(GRAPH_B) < 0.3 for _ in range(5)]
        tails = rng.standard_normal((GRAPH_B, 352)).astype(np.float32)
        lasts = rng.standard_normal(GRAPH_B).astype(np.float32)
        calls = (("compact_state", (cfg,), {}),
                 ("compact_state", (cfg,), dict(mask=masks[0])),
                 ("compact_state", (cfg,), dict(phase=3, mask=masks[1])),
                 ("realign_state", (cfg,), dict(delta=1, mask=masks[2])),
                 ("realign_state", (cfg,), dict(delta=-6, mask=masks[3])),
                 ("reset_state", (), dict(mask=masks[4], cfg=cfg)),
                 ("prime_frontend", (), dict(mask=masks[4], tails=tails,
                                             lasts=lasts, cfg=cfg)))
        check = slot_ops_sync_errors(graphed) if rnd == 2 else \
            contextlib.nullcontext()
        with check:
            for name, args, kw in calls:
                for i, m in enumerate((graphed, eager)):
                    if name in ("compact_state", "realign_state"):
                        states[i] = getattr(m, name)(args[0], states[i], **kw)
                    else:
                        states[i] = getattr(m, name)(states[i], **kw)
                torch.cuda.synchronize()
                assert compare(*states)["equal"], (rnd, name, kw)
    for (key, _), e in graphed.graphs.entries.items():
        # the capturing call replays what it captured
        assert (e.calls, e.captures, e.replays) == (3, 1, 2), (key, e)
    assert len(graphed.graphs.entries) == 7
    stats = graphed.graphs.stats()
    print(f"{form}: slot graphs {stats}")


def test_engine_groups_capture_each_slot_key_once(cuda):
    """Two engine groups of one graphed model at full width (bf16, right
    contexts 0 and 6, batch 8), prewarmed, then streams joining each group
    in turn: each group's slot keys are its own, so each is captured once
    (at the prewarm) and every join replays it, with no recapture."""
    from nemotron_tpu_torch.graphs import SLOT_KEYS
    from nemotron_tpu_torch.streaming.engine import BatchedEngine
    from nemotron_tpu_torch.tools.graph_turns import join_in_turns

    model = ASRModel.random(Hparams(), seed=0, dtype=torch.bfloat16,
                            device=cuda)
    engine = BatchedEngine(model, batch_per_group=8)
    engine.prewarm(right_contexts=(0, 6))
    join_in_turns(engine, (0, 6), joins=4)
    slot = {key: e for (key, _), e in model.graphs.entries.items()
            if key[0] in SLOT_KEYS}
    for kind in ("prime", "reset"):
        assert len([k for k in slot if k[0] == kind]) == 2, kind
    for key, e in slot.items():
        assert e.captures == 1, (key, e.captures, e.calls)
    for rc in (0, 6):
        reset = slot[("reset", engine.groups[rc].cfg)]
        assert reset.replays == reset.calls - 1 == 5, rc
    assert model.graphs.stats(lambda k: k[0] in SLOT_KEYS)["recaptures"] == 0


# --- a tp group's calls as CUDA graphs (each rank on a stream of its own) --

TP_GRAPH_FORMS = ("f32", "bf16-block-int8kv", "f32-q8")
TP_B = 8  # four slots per dp shard


def _tp_pair(form, mesh):
    """(graphed, eager) models on `mesh` with the same small random
    weights (d_ff 128: the tp = 2 slices keep whole Q8_0 blocks)."""
    from dataclasses import replace

    from nemotron_tpu_torch.tools.graph_turns import twin

    dtype = torch.bfloat16 if form.startswith("bf16") else torch.float32
    graphed = ASRModel.random(replace(_tiny_hp(), d_ff=128), seed=1,
                              dtype=dtype, device="cuda",
                              kv_int8="int8kv" in form,
                              attn_block="block" in form)
    if "q8" in form:
        graphed.params = quantize_encoder_layers(graphed.params, bits=8)
    graphed.shard(mesh)
    return graphed, twin(graphed)


def _tp_graphed_equals_eager(form, mesh):
    from nemotron_tpu_torch.tools.graph_turns import compare, run_schedule

    graphed, eager = _tp_pair(form, mesh)
    kernels.reset_counts()
    tok_e, st_e = run_schedule(eager, TP_B)
    n_eager = _launches()
    kernels.reset_counts()
    tok_g, st_g = run_schedule(graphed, TP_B, sync_debug=True)
    n_graphed = _launches()
    cmp = compare(st_g, st_e)
    stats = graphed.graphs.stats()
    print(f"{form} on {mesh}: {cmp}, graphs {stats}, launches {n_graphed}")
    assert len(tok_g) == len(tok_e)
    assert all(np.array_equal(g, e) for g, e in zip(tok_g, tok_e))
    if form == "f32":
        assert cmp["max_abs"] <= 1e-6, cmp
    else:
        assert cmp["equal"], cmp
    # 11 tick keys and 4 slot keys, each captured once per dp shard
    n_dp = mesh.shape["dp"]
    assert stats["captures"] == stats["keys"] == 15 * n_dp, stats
    assert stats["recaptures"] == 0 and stats["replays"] > stats["captures"]
    for (key, shard), e in graphed.graphs.entries.items():
        assert e.devices == tuple(graphed.groups[shard].devices), key
    assert n_graphed == n_eager
    assert n_graphed["kv_rows"] > 0 and n_graphed["mel_frames"] > 0
    want = {"f32": "t1_attention", "bf16-block-int8kv": "t1_attention_block",
            "f32-q8": "q8_matmul"}[form]
    assert n_graphed[want] > 0
    return graphed


@pytest.mark.parametrize("form", TP_GRAPH_FORMS)
def test_tp_mesh_graphed_equals_eager_on_one_card(cuda, form):
    """tools/graph_turns.run_schedule (wraps, the backlog, a masked tick
    and its realign, a join; warm-up, capture, replay) at B=8 on a 2x2 mesh
    of cuda:0, graphed against its eager twin: tokens equal, leaves
    bit-equal (f32 within 1e-6), each key captured once per dp shard with
    its tp group's devices, the last pass under set_sync_debug_mode
    ("error"), and the launches through the replays equal to eager's (B1,
    B3 or B4 by form inside the tp graphs)."""
    from nemotron_tpu_torch.parallel.mesh import make_mesh

    _tp_graphed_equals_eager(form, make_mesh(2, 2, devices=["cuda:0"] * 4))


def test_tp_mesh_graphed_across_two_cards(cuda):
    """The same on a 1x2 mesh across two cards (peer copies as graph
    nodes, the second card's graph pool); skips on one card."""
    from nemotron_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    graphed = _tp_graphed_equals_eager("f32", make_mesh(1, 2))
    assert graphed.graphs.stats()["pool_bytes"] > 0


def test_tp_rank_partials_outlive_the_reduction(cuda):
    """A rank's partial is made on the rank's stream and read by the lead's
    reduction: no block of it (nor of a lead tensor a rank reads) may be
    handed out again before that read. The eager 2x2 schedule twice, the
    allocator's cache emptied between, so the second run's blocks fall
    elsewhere: leaves bit-equal between the runs and within 1e-5 of one
    device's (no streams); then graphed, bit-equal to them."""
    from nemotron_tpu_torch.parallel.mesh import make_mesh
    from nemotron_tpu_torch.tools.graph_turns import (compare, run_schedule,
                                                      twin)

    graphed, eager = _tp_pair("f32", make_mesh(2, 2,
                                               devices=["cuda:0"] * 4))
    single = ASRModel(graphed.hp, graphed.params, graphed.tokenizer.vocab,
                      device="cuda", graphs=False)
    tok_1, st_1 = run_schedule(single, 32, passes=1)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        runs.append(run_schedule(twin(graphed), 32, passes=1))
    assert compare(runs[0][1], runs[1][1])["equal"]
    assert all(np.array_equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert all(np.array_equal(a, b) for a, b in zip(runs[0][0], tok_1))
    assert compare(runs[0][1], st_1)["max_abs"] <= 1e-5
    tok_g, st_g = run_schedule(graphed, 32, passes=3)
    assert compare(st_g, run_schedule(eager, 32, passes=3)[1])[
        "max_abs"] <= 1e-6


def test_tp_offline_graphed_equals_eager(cuda):
    """The offline path on a 2x2 mesh of cuda:0 (dp shard 0's tp group in
    the encoder's graph, the decode and its carry on the lead), three
    calls graphed against one eager: token ids, frames and the decoder
    state equal; the encoder key captured once, with the group's
    devices."""
    from nemotron_tpu_torch.parallel.mesh import make_mesh

    graphed, eager = _tp_pair("f32", make_mesh(2, 2,
                                               devices=["cuda:0"] * 4))
    rng = np.random.default_rng(4)
    audios = [(rng.standard_normal(n) * 3000).astype(np.int16)
              for n in (7000, 12800)]
    mels = process_many([eager._preprocessor() for _ in audios], audios)
    want, want_state = eager._transcribe_mels(mels, None)
    for call in ("warm-up", "capture", "replay"):
        got, state = graphed._transcribe_mels(mels, None)
        torch.cuda.synchronize()
        assert got == want, call
        for f in ("h", "c", "prev_token", "frame_offset"):
            assert torch.equal(getattr(state, f),
                               getattr(want_state, f)), (call, f)
    enc = {key: e for (key, _), e in graphed.graphs.entries.items()
           if key[0] == "batch"}
    assert len(enc) == 1
    e, = enc.values()
    assert (e.calls, e.captures, e.replays) == (3, 1, 2)
    assert e.devices == tuple(graphed.groups[0].devices)
