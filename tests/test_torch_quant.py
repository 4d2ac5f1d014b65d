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
    tp = tparams.quantize_encoder_layers(tparams.random_params(hp, seed=3),
                                         bits=bits)
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
    _, tp, _ = tparams.load_model(path, keep_quantized=keep)
    assert_trees_equal(jp, tp)
    quantized = {f for f in tparams._LAYER_MAP
                 if tq.is_quantized(getattr(tp.layers, f))}
    want = {GGML_Q8_0: set(tparams.QUANT_LAYER_FIELDS),
            GGML_Q4_0: set(tparams.QUANT_LAYER_FIELDS) - {"ffn1_w2",
                                                          "ffn2_w2"}}
    assert quantized == (want[ggml_type] if keep else set())
    # bf16: dense leaves cast, quantized leaves keep their bits
    _, tb, _ = tparams.load_model(path, dtype=torch.bfloat16,
                                  keep_quantized=keep)
    assert tb.layers.norm_ff1_w.dtype == torch.bfloat16
    for f in quantized:
        assert_same_bits(getattr(tp.layers, f), getattr(tb.layers, f))


def test_params_to_and_from_numpy_carry_quantized_leaves():
    hp = tiny_hparams()
    jp = jparams.quantize_encoder_layers(jparams.random_params(hp, seed=2))
    tp = tparams.params_from_numpy(jp)
    assert_trees_equal(jp, tp)
    bf = tparams.params_to(tp, dtype=torch.bfloat16)
    assert bf.layers.ffn1_w1.w_i8.dtype == torch.int8
    assert bf.layers.ffn1_w1.scales.dtype == torch.float32
    assert bf.layers.conv_dw_w.dtype == torch.bfloat16
    j4 = jparams.quantize_encoder_layers(jparams.random_params(hp, seed=2),
                                         bits=4)
    t4 = tparams.params_to(tparams.params_from_numpy(j4),
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
