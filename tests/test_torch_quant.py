"""Weight-only Q8_0 / Q4_0 in the port against the JAX package, at tiny size
on the CPU (where the port's linears take their plain versions; kernels B4
and B5 are held against those plain versions on the card in
tests/test_torch_gpu.py).

Exact: the quantizers, the GGUF readers, dequantization, and the loaded or
quantized parameter trees (both packages compute the same f32 values).
Within 1e-5 in f32 (sums in another order): the plain linears against the
JAX package's default XLA path. Within the JAX package's own bound of
2e-2 x max|y| (tests/test_quant.py): against its Pallas kernels in
interpret mode, which round the operands to bf16. Tokens equal over the
lockstep schedule segments of tests/test_torch_tick.py with Q8_0 and Q4_0
encoders."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import rand, tiny_hparams
from scripts_support import export_random_checkpoint
from test_torch_params import assert_trees_equal
from test_torch_tick import SEGMENTS, run_segment

from nemotron_tpu import params as jparams
from nemotron_tpu.gguf.reader import GGML_Q4_0, GGML_Q8_0, read_gguf
from nemotron_tpu.gguf.writer import write_gguf
from nemotron_tpu.ops import quant as jq
from nemotron_tpu_torch import params as tparams
from nemotron_tpu_torch.ops import quant as tq
from nemotron_tpu_torch.ops.basic import linear

torch.set_num_threads(1)

# bits -> (JAX quantizer, port quantizer, JAX dequantize, port dequantize,
#          JAX XLA linear, JAX Pallas linear, port plain linear, port
#          wrapper, GGML type, JAX reader, port reader)
KINDS = {
    8: (jq.quantize_q8, tq.quantize_q8, jq.dequantize, tq.dequantize,
        jq.linear_q8_xla, jq.linear_q8_pallas, tq.linear_q8_ref,
        tq.linear_q8, GGML_Q8_0, jq.from_gguf_q8, tq.from_gguf_q8),
    4: (jq.quantize_q4, tq.quantize_q4, jq.dequantize_q4, tq.dequantize_q4,
        jq.linear_q4_xla, jq.linear_q4_pallas, tq.linear_q4_ref,
        tq.linear_q4, GGML_Q4_0, jq.from_gguf_q4, tq.from_gguf_q4),
}


def leaves(qt):
    """The arrays of a quantized tensor of either package, as numpy."""
    return [np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for v in ((qt.w_i8, qt.scales) if hasattr(qt, "w_i8")
                      else (qt.w_packed, qt.scales))]


def assert_same_bits(jqt, tqt):
    for j, t in zip(leaves(jqt), leaves(tqt)):
        assert j.dtype == t.dtype and j.shape == t.shape
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_and_dequantize_equal_jax(bits):
    jquant, tquant, jdeq, tdeq = KINDS[bits][:4]
    w = rand(3, 48, 128, seed=bits)
    w[0, 5, :32] = 0.0  # an all-zero block takes scale 1
    tqt = tquant(w)     # rank-generic: the stacked [L, out, in] at once
    for i in range(3):
        assert_same_bits(jquant(w[i]), tqt[i])
        np.testing.assert_array_equal(tdeq(tqt[i]).numpy(),
                                      np.asarray(jdeq(jquant(w[i]))))
    assert tdeq(tqt, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("bits", [8, 4])
def test_from_gguf_equals_jax(tmp_path, bits):
    ggml_type, jread, tread = KINDS[bits][8:]
    w = rand(32, 128, seed=2)
    path = str(tmp_path / "w.gguf")
    write_gguf(path, {}, {"w": w}, {"w": ggml_type})
    g = read_gguf(path)
    raw = g.raw_tensor("w")
    tqt = tread(raw, 32, 128)
    assert_same_bits(jread(raw, 32, 128), tqt)
    np.testing.assert_array_equal(KINDS[bits][3](tqt).numpy(),
                                  g.load_all()["w"])  # the reader's dequant


@pytest.mark.parametrize("bits", [8, 4])
def test_plain_linear_matches_xla_and_pallas(bits):
    jquant, tquant, _, _, jxla, jpallas, tref, twrap = KINDS[bits][:8]
    w = rand(128, 256, seed=5, scale=1 / 16)  # a layer's 1/sqrt(in) scale
    x = rand(2, 3, 256, seed=6)
    jqt, tqt = jquant(w), tquant(w)
    got = tref(torch.from_numpy(x), tqt).numpy()
    np.testing.assert_allclose(got, np.asarray(jxla(jnp.asarray(x), jqt)),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(twrap(torch.from_numpy(x), tqt).numpy(),
                                  got)  # CPU tensors take the plain version
    pallas = np.asarray(jpallas(jnp.asarray(x), jqt, interpret=True))
    assert np.abs(got - pallas).max() / np.abs(pallas).max() < 2e-2


@pytest.mark.parametrize("bits", [8, 4])
def test_linear_dispatches_on_the_weight(bits):
    tquant, tref = KINDS[bits][1], KINDS[bits][6]
    w = rand(40, 64, seed=3)
    x = torch.from_numpy(rand(5, 64, seed=4))
    b = torch.from_numpy(rand(40, seed=7))
    qt = tquant(w)
    torch.testing.assert_close(linear(x, qt, b), tref(x, qt) + b, atol=0,
                               rtol=0)
    torch.testing.assert_close(linear(x, torch.from_numpy(w), b),
                               torch.nn.functional.linear(
                                   x, torch.from_numpy(w), b), atol=0, rtol=0)


def test_kernel_wrappers_refuse_bad_shapes():
    qt = tq.quantize_q8(rand(16, 64, seed=1))
    with pytest.raises(ValueError):  # no such kernel off CPU and CUDA
        tq.linear_q8(torch.zeros(2, 64), tq.QuantizedTensor(
            qt.w_i8.to("meta"), qt.scales.to("meta")))
    with pytest.raises(ValueError, match="multiple of 64"):
        tq.quantize_q4(rand(16, 96, seed=1))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_encoder_layers_equals_jax(bits):
    hp = tiny_hparams()
    jp = jparams.quantize_encoder_layers(jparams.random_params(hp, seed=3),
                                         bits=bits)
    tp = tparams.quantize_encoder_layers(
        tparams.random_params(hp, seed=3, device="cpu"), bits=bits)
    assert_trees_equal(jp, tp)  # codes, scales and dense leaves, exactly
    quantized = {f for f in tparams.QUANT_LAYER_FIELDS
                 if tq.is_quantized(getattr(tp.layers, f))}
    # d_ff 96: ffn*_w2 (input width 96) stays dense under Q4_0 only
    dense = {"ffn1_w2", "ffn2_w2"} if bits == 4 else set()
    assert quantized == set(tparams.QUANT_LAYER_FIELDS) - dense
    assert tparams.QUANT_LAYER_FIELDS == jparams.QUANT_LAYER_FIELDS


def _quantized_checkpoint(tmp_path, ggml_type):
    """A tiny GGUF whose encoder-layer matrices are Q8_0 or Q4_0 (the
    pattern of tests/test_quant.py; Q4_0 only where the input width is a
    multiple of 64, as the converter would)."""
    hp = tiny_hparams()
    dense = str(tmp_path / "dense.gguf")
    tensors = export_random_checkpoint(hp, dense, seed=9)
    pat = re.compile(r"encoder\.layers\.\d+\.(feed_forward\d+|self_attn|conv)"
                     r"\.[^.]+\.weight$")
    step = 32 if ggml_type == GGML_Q8_0 else 64
    types = {n: ggml_type for n, a in tensors.items()
             if pat.search(n) and a.ndim == 2 and a.shape[-1] % step == 0
             and "depthwise" not in n}
    path = str(tmp_path / "q.gguf")
    write_gguf(path, read_gguf(dense).kv, tensors, types)
    return path


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("ggml_type", [GGML_Q8_0, GGML_Q4_0])
def test_load_quantized_gguf_equals_jax(tmp_path, ggml_type, keep):
    path = _quantized_checkpoint(tmp_path, ggml_type)
    _, jp, _ = jparams.load_model(path, keep_quantized=keep)
    _, tp, _ = tparams.load_model(path, keep_quantized=keep,
                                 device="cpu")
    assert_trees_equal(jp, tp)
    quantized = {f for f in tparams._LAYER_MAP
                 if tq.is_quantized(getattr(tp.layers, f))}
    want = {GGML_Q8_0: set(tparams.QUANT_LAYER_FIELDS),
            GGML_Q4_0: set(tparams.QUANT_LAYER_FIELDS) - {"ffn1_w2",
                                                          "ffn2_w2"}}
    assert quantized == (want[ggml_type] if keep else set())
    # bf16: dense leaves cast, quantized leaves keep their bits
    _, tb, _ = tparams.load_model(path, dtype=torch.bfloat16,
                                  keep_quantized=keep, device="cpu")
    assert tb.layers.norm_ff1_w.dtype == torch.bfloat16
    for f in quantized:
        assert_same_bits(getattr(tp.layers, f), getattr(tb.layers, f))


def test_params_to_and_from_numpy_carry_quantized_leaves():
    hp = tiny_hparams()
    jp = jparams.quantize_encoder_layers(jparams.random_params(hp, seed=2))
    tp = tparams.params_from_numpy(jp, device="cpu")
    assert_trees_equal(jp, tp)
    bf = tparams.params_to(tp, dtype=torch.bfloat16)
    assert bf.layers.ffn1_w1.w_i8.dtype == torch.int8
    assert bf.layers.ffn1_w1.scales.dtype == torch.float32
    assert bf.layers.conv_dw_w.dtype == torch.bfloat16
    j4 = jparams.quantize_encoder_layers(jparams.random_params(hp, seed=2),
                                         bits=4)
    t4 = tparams.params_to(tparams.params_from_numpy(j4, device="cpu"),
                           dtype=torch.bfloat16)
    assert t4.layers.attn_q_w.w_packed.dtype == torch.uint8
    assert_same_bits(j4.layers.attn_q_w, t4.layers.attn_q_w)
    lp = tparams.layer_slice(tp.layers, 1)  # views of the codes
    assert lp.ffn1_w1.w_i8.data_ptr() == tp.layers.ffn1_w1.w_i8[1].data_ptr()


@pytest.mark.parametrize("segment", list(SEGMENTS))
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tick_matches_jax(bits, segment):
    run = run_segment(segment, quant_bits=bits)
    assert tq.is_quantized(run.tm.params.layers.attn_q_w)


# The main path's (N, K): ffn*_w1, ffn*_w2, conv_pw1_w, attention / conv_pw2_w
MAIN_SHAPES = [(4096, 1024), (1024, 4096), (2048, 1024), (1024, 1024)]


@pytest.mark.parametrize("bits", [8, 4])
def test_gemm_plan_covers_every_column_once(bits):
    """Every plan of the bf16 body (batch tiles, split-K) for the main
    path's shapes, ragged ones, and cards of other SM counts: each K column
    lies in exactly one split, no split is empty, the batch fits the
    tiles."""
    shapes = MAIN_SHAPES + [(200, 128), (96, 64)] + (
        [(64, 96)] if bits == 8 else [])
    for n, k in shapes:
        for m in (1, 7, 8, 32, 141, 256, 300, 513, 769, 1792, 3583, 6152,
                  16384):
            for sms in (132, 114, 78):
                check_gemm_plan(m, n, k, bits, sms)


def check_gemm_plan(m, n, k, bits, sms):
    p = tq.gemm_plan(m, n, k, bits, sms)
    if isinstance(p, tq.LargePlan):
        assert m >= tq.LARGE_MIN_M and n % 8 == 0
        assert p.blocks == min(sms, p.tiles)
        check_large_plan(p, m, n, k)
        return
    assert m < tq.LARGE_MIN_M or n % 8
    cols = p.split_columns(k, bits)
    assert len(cols) == p.splits and all(len(c) for c in cols)
    flat = np.concatenate(cols)
    np.testing.assert_array_equal(np.sort(flat), np.arange(k))
    assert (p.splits - 1) * p.steps_per < p.steps <= p.splits * p.steps_per
    assert p.m_tile in tq.GEMM_M_TILES
    assert p.m_tile * p.tiles_m >= m > p.m_tile * (p.tiles_m - 1)
    # more than one batch tile only of at least 64 rows each
    assert p.tiles_m == 1 or -(-m // p.tiles_m) >= tq.GEMM_MIN_ROWS
    blocks = -(-n // tq.GEMM_ROWS) * p.tiles_m
    if blocks * 2 <= sms and p.steps >= 2 * tq.GEMM_MIN_STEPS:
        assert p.splits > 1  # idle SMs take a share of K


@pytest.mark.parametrize("bits", [8, 4])
def test_gemm_plan_routes_every_row(bits):
    """gemm_plan's route at every M from 1 to 16,384 (the R=0 tick's 1-256
    streams, the right-context ticks' B x chunk_len, the offline path's B x
    T'), for the main path's shapes on an H100's 132 SMs: the M <= 256 form
    below tq.LARGE_MIN_M rows, the large-M form from there on; each plan
    covers the batch and K (check_gemm_plan, check_large_plan's counts)."""
    for n, k in MAIN_SHAPES:
        steps = -(-(k if bits == 8 else k // 2) // tq.GEMM_STEP)
        for m in range(1, 16385):
            p = tq.gemm_plan(m, n, k, bits, 132)
            if m < tq.LARGE_MIN_M:
                assert isinstance(p, tq.GemmPlan), m
                assert p.m_tile * p.tiles_m >= m > p.m_tile * (p.tiles_m - 1)
                assert (p.splits - 1) * p.steps_per < p.steps == steps
                assert p.steps <= p.splits * p.steps_per
                continue
            assert isinstance(p, tq.LargePlan), m
            assert p.bn in tq.LARGE_BN and p.steps == -(-k // tq.GEMM_STEP)
            assert p.tiles_m * tq.LARGE_ROWS >= m
            assert m > (p.tiles_m - 1) * tq.LARGE_ROWS
            assert p.tiles_n * p.bn >= n > (p.tiles_n - 1) * p.bn
            assert p.blocks == min(132, p.tiles)
        for m in (1, 255, 256, 769, tq.LARGE_MIN_M - 1, tq.LARGE_MIN_M,
                  1792, 3583, 6151, 16384):
            check_gemm_plan(m, n, k, bits, 132)


def check_large_plan(p, m, n, k):
    """The large-M plan's blocks walk every output tile once, its tile grid
    covers [m, n] and no tile lies wholly past it; its steps cover K."""
    hits = np.zeros((p.tiles_m, p.tiles_n), int)
    for b in range(p.blocks):
        for r0, c0 in p.block_tiles(b):
            assert r0 % tq.LARGE_ROWS == 0 and c0 % p.bn == 0
            hits[r0 // tq.LARGE_ROWS, c0 // p.bn] += 1
    assert (hits == 1).all()
    assert p.tiles_m * tq.LARGE_ROWS >= m > (p.tiles_m - 1) * tq.LARGE_ROWS
    assert p.tiles_n * p.bn >= n > (p.tiles_n - 1) * p.bn
    assert (p.steps - 1) * tq.GEMM_STEP < k <= p.steps * tq.GEMM_STEP


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("n, k", MAIN_SHAPES)
@pytest.mark.parametrize("bits", [8, 4])
def test_split_k_emulation_matches_plain_and_xla(bits, n, k):
    """A plain emulation of the bf16 body's partition: per split, the f32
    product of x and the weights (rounded as the plain version rounds
    them) over that split's K columns; the partials summed in split order,
    rounded once. Held against the port's plain linear and the JAX
    package's XLA linear within one bf16 ulp of max|y|, in bf16 and f32."""
    jquant, tquant, _, tdeq, jxla, _, tref = KINDS[bits][:7]
    w = rand(n, k, seed=n + k, scale=k ** -0.5)
    jqt, tqt = jquant(w), tquant(w)
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        wd = tdeq(tqt, dtype).float()
        for m in (1, 8, 141, 256):
            x = torch.from_numpy(rand(m, k, seed=m)).to(dtype)
            plan = tq.gemm_plan(m, n, k, bits, 132)
            acc = torch.zeros(m, n)
            for cols in plan.split_columns(k, bits):
                idx = torch.from_numpy(cols)
                acc += x.float()[:, idx] @ wd[:, idx].T
            got = acc.to(dtype).float()
            want = tref(x, tqt).float()
            tol = _bf16_ulp(float(want.abs().max()))
            assert float((got - want).abs().max()) <= tol, (dtype, m)
            jx = jnp.asarray(x.float().numpy()).astype(jdt)
            xla = np.asarray(jxla(jx, jqt).astype(jnp.float32))
            assert float(np.abs(got.numpy() - xla).max()) <= tol, (dtype, m)


@pytest.mark.parametrize("bn", [None] + list(tq.LARGE_BN))
@pytest.mark.parametrize("bits", [8, 4])
def test_large_form_emulation_matches_plain_xla_and_pallas(bits, bn):
    """A plain emulation of the large-M form: the weight dequantized to bf16
    once (each weight rounded once from its f32 product), then each
    persistent block's 128 x bn output tiles in its order, each output one
    f32 sum over all of K rounded once to bf16. At a ragged batch past the
    crossover (on gemm_plan's plan, or at each tile width) and ragged N,
    held against the port's plain linear and the JAX package's XLA linear
    within one bf16 ulp of max|y|, and against its Pallas kernel
    (interpret mode) within the JAX package's own 2e-2 x max|y|."""
    jquant, tquant, _, tdeq, jxla, jpallas, tref = KINDS[bits][:7]
    m, n, k = tq.LARGE_MIN_M + 5, 384, 256
    w = rand(n, k, seed=bits + 11, scale=k ** -0.5)
    jqt, tqt = jquant(w), tquant(w)
    x = torch.from_numpy(rand(m, k, seed=bits + 12)).to(torch.bfloat16)
    p = (tq.gemm_plan(m, n, k, bits, 132) if bn is None
         else tq.large_plan(m, n, k, 132, bn))
    assert isinstance(p, tq.LargePlan)
    check_large_plan(p, m, n, k)
    wb = tdeq(tqt, torch.bfloat16).float()  # pass 1, once per call
    got = torch.full((m, n), float("nan"))
    for b in range(p.blocks):
        for r0, c0 in p.block_tiles(b):
            tile = x.float()[r0:r0 + tq.LARGE_ROWS] @ wb[c0:c0 + p.bn].T
            got[r0:r0 + tq.LARGE_ROWS, c0:c0 + p.bn] = tile.to(
                torch.bfloat16).float()
    want = tref(x, tqt).float()
    tol = _bf16_ulp(float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    xla = np.asarray(jxla(jx, jqt).astype(jnp.float32))
    assert float(np.abs(got.numpy() - xla).max()) <= tol
    pallas = np.asarray(jpallas(jx, jqt, interpret=True).astype(jnp.float32))
    assert np.abs(got.numpy() - pallas).max() / np.abs(pallas).max() < 2e-2


# the f32 body's plans: the main path's shapes and ragged ones (Q4_0 takes
# K % 64 == 0), at ragged and full batches, on cards of other SM counts
F32_SHAPES = MAIN_SHAPES + [(200, 128), (96, 64), (3072, 1024), (128, 4096)]
F32_BATCHES = (1, 17, 141, 256)
# the right-context ticks' and the offline path's rows
F32_LARGE_BATCHES = (512, 769, 1792, 3584, 6152, 16384)


@pytest.mark.parametrize("n, k", F32_SHAPES)
def test_f32_plan_covers_every_output_and_column_once(n, k):
    """Every plan of the f32 FFMA body (ops/quant.py:f32_plan): its batch and
    weight-row tiles cover each output element once, its splits each K
    column once, none empty; it fills the SMs up to one wave and never
    splits past it."""
    for m in F32_BATCHES + (7, 64, 300):
        for sms in (132, 114, 78):
            check_f32_plan(m, n, k, sms)


@pytest.mark.parametrize("n, k", MAIN_SHAPES)
def test_f32_plan_covers_the_large_rows(n, k):
    """f32_plan at the right-context ticks' and the offline path's rows:
    its tiles cover the output (counted per tile), its splits each K
    column once, within one wave of blocks or unsplit."""
    for m in F32_LARGE_BATCHES:
        for sms in (132, 114, 78):
            p = tq.f32_plan(m, n, k, sms)
            assert p.bm in tq.F32_M_TILES
            assert p.tiles_m * p.bm >= m > (p.tiles_m - 1) * p.bm
            assert p.tiles_n * tq.F32_ROWS >= n > (p.tiles_n - 1) * tq.F32_ROWS
            np.testing.assert_array_equal(
                np.concatenate(p.split_columns(k)), np.arange(k))
            assert p.blocks <= max(sms, p.tiles)


def test_f32_plan_refit_keeps_the_single_wave_plans(monkeypatch):
    """f32_plan's 64-row penalty where the tiles take more than one wave
    (F32_COST_64_WAVES, fitted at the large rows) moves no plan whose
    tiles fit one wave: at every M <= 256 on 132 and 114 SMs (the R=0
    tick's B4/B5, B3's projections with their split caps) the plan equals
    the one of the cost model without it; at the large rows of the main
    path's shapes it takes 128-row tiles."""
    shapes = MAIN_SHAPES + [(3072, 1024), (512, 1024), (2048, 4096)]
    got = {(m, n, k, sms, cap): tq.f32_plan(m, n, k, sms, cap)
           for n, k in shapes for m in range(1, 257) for sms in (132, 114)
           for cap in (None, 1, 2, 4, 8)}
    large = {(m, n, k): tq.f32_plan(m, n, k, 132)
             for n, k in MAIN_SHAPES for m in F32_LARGE_BATCHES}
    tq.f32_plan.cache_clear()
    monkeypatch.setattr(tq, "F32_COST_64_WAVES", tq.F32_COST_64)
    try:
        for key, plan in got.items():
            assert tq.f32_plan(*key) == plan, key
    finally:
        tq.f32_plan.cache_clear()
    assert all(p.bm == 128 for p in large.values()), large


def check_f32_plan(m, n, k, sms):
    p = tq.f32_plan(m, n, k, sms)
    assert p.bm in tq.F32_M_TILES
    assert p.tiles_m * p.bm >= m > (p.tiles_m - 1) * p.bm
    assert p.tiles_n * tq.F32_ROWS >= n > (p.tiles_n - 1) * tq.F32_ROWS
    out = np.zeros((p.tiles_m * p.bm, p.tiles_n * tq.F32_ROWS), int)
    for t in range(p.tiles):
        r, c = divmod(t, p.tiles_n)
        out[r * p.bm:(r + 1) * p.bm,
            c * tq.F32_ROWS:(c + 1) * tq.F32_ROWS] += 1
    assert (out[:m, :n] == 1).all()
    cols = p.split_columns(k)
    assert len(cols) == p.splits and all(len(c) for c in cols)
    np.testing.assert_array_equal(np.concatenate(cols), np.arange(k))
    assert p.steps == -(-k // tq.F32_STEP)
    assert (p.splits - 1) * p.steps_per < p.steps <= p.splits * p.steps_per
    assert p.blocks <= max(sms, p.tiles)  # one wave
    if p.splits == 1 and p.steps > 1:
        assert 2 * p.tiles > sms  # a split would not fit the wave


@pytest.mark.parametrize("n, k", MAIN_SHAPES)
@pytest.mark.parametrize("bits", [8, 4])
def test_f32_split_k_emulation_matches_plain_and_xla(bits, n, k):
    """A plain emulation of the f32 body's partition: per split, the f32
    product of x and the dequantized weights over that split's K columns;
    the partials added in split order (as the tile's last block adds them).
    Held against the port's plain linear and the JAX package's XLA linear
    within 1e-5 x max|y|."""
    jquant, tquant, _, tdeq, jxla, _, tref = KINDS[bits][:7]
    w = rand(n, k, seed=n + k + 1, scale=k ** -0.5)
    jqt, tqt = jquant(w), tquant(w)
    wd = tdeq(tqt, torch.float32)
    for m in F32_BATCHES:
        x = torch.from_numpy(rand(m, k, seed=m + 1))
        plan = tq.f32_plan(m, n, k, 132)
        acc = None
        for cols in plan.split_columns(k):
            idx = torch.from_numpy(cols)
            part = x[:, idx] @ wd[:, idx].T
            acc = part if acc is None else acc + part
        want = tref(x, tqt)
        tol = 1e-5 * float(want.abs().max())
        assert float((acc - want).abs().max()) <= tol, m
        xla = np.asarray(jxla(jnp.asarray(x.numpy()), jqt))
        assert float(np.abs(acc.numpy() - xla).max()) <= tol, m
