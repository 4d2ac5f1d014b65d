"""The yardstick's arithmetic (roofline.py) and the nemotron architecture's
model counts (archs/fastconformer_rnnt/counts.py) against values worked
out by hand."""

from __future__ import annotations

import pytest

from portbench import roofline as R
from portbench.archs.fastconformer_rnnt import counts as C

HP = {"n_mels": 128, "d_model": 1024, "n_heads": 8, "d_head": 128,
      "d_ff": 4096, "n_layers": 24, "kernel_size": 9, "vocab_size": 1025,
      "decoder_dim": 640, "joint_dim": 640, "subsampling_factor": 8,
      "subsampling_channels": 256, "att_left_context": 70, "num_prompts": 0,
      "max_pos_len": 2048}


def test_q8_linear():
    # M=2048 rows of x [2048, 1024] through W [4096, 1024]
    ops, nbytes = R.q8_linear(2048, 4096, 1024)
    assert ops == 2 * 2048 * 4096 * 1024 == 17_179_869_184
    # 4,194,304 weights at 34 bytes a 32 = 4,456,448; x 4 MiB, y 16 MiB
    assert nbytes == 4_456_448 + 4_194_304 + 16_777_216
    # operations bind: 17.18 GFLOP / 989 TFLOP/s = 17.37 us
    assert R.bound_s(ops, nbytes) == pytest.approx(17.3709e-6, rel=1e-4)
    # a small M is bound by bytes: 1 row, 4,456,448 + 2,048 + 8,192 bytes
    ops, nbytes = R.q8_linear(1, 4096, 1024)
    assert R.bound_s(ops, nbytes) == pytest.approx(4_466_688 / 3.35e12)


def test_t1_attention():
    # 2048 streams, 8 heads, 71 keys, 128 dims, bf16
    ops, nbytes = R.t1_attention(2048, 8, 71, 128)
    assert ops == 4 * 2048 * 8 * 71 * 128 == 595_591_168
    kv = 2 * 2048 * 8 * 71 * 128 * 2          # 595,591,168 bytes
    small = 4 * 2048 * 8 * 128 * 2            # q, k, v new, out: 16 MiB
    assert nbytes == kv + small == 612_368_384
    # bytes bind: 612.4 MB / 3.35 TB/s
    assert R.bound_s(ops, nbytes) == pytest.approx(182.796e-6, rel=1e-4)


def test_frames_and_model_flops():
    # per layer: 4 FFN matrices 2*4096*1024 each, q k v out 2*1024^2 each,
    # pw1 2*2048*1024, pw2 2*1024^2, depthwise 2*9*1024
    per_layer = 4 * 8_388_608 + 4 * 2_097_152 + 4_194_304 + 2_097_152 \
        + 18_432
    # subsampling: widths 65 / 33 / 17 after each stride-2 level
    sub = 2 * (9 * 256 * 4 * 65 + 9 * 256 * 2 * 33 + 256 * 256 * 2 * 33
               + 9 * 256 * 17 + 256 * 256 * 17 + 17 * 256 * 1024)
    assert C.subsampling_flops(HP) == sub == 21_372_416
    joint_enc = 2 * 1024 * 640
    assert C.frame_flops(HP) == 24 * per_layer + sub + joint_enc
    assert 1.15e9 < 24 * per_layer < 1.17e9   # ~1.16 GFLOP a frame
    assert C.attention_flops(HP, 1, 71) == 24 * 6 * 1024 * 71
    # LSTM: 2 layers x 2 x 4*640 x (640 + 640); joint: 640x640, 640x1025
    it = 2 * 2 * 2560 * 1280 + 2 * 640 * 640 + 2 * 640 * 1025
    assert C.decode_iteration_flops(HP) == it == 15_238_400
    assert C.stream_chunk_flops(HP, 0) == C.frame_flops(HP) \
        + 24 * 6 * 1024 * 71 + 12 * it
    assert C.stream_chunk_flops(HP, 13) == 14 * C.frame_flops(HP) \
        + 24 * 6 * 1024 * 14 * 84 + 155 * it
    assert C.stream_step_flops(HP, 0) == 24 * 2 * 141 * 1024 ** 2


def test_stream_linear_calls():
    calls = C.stream_linear_calls(HP, ["ffn1_w1", "attn_pos_w"], 2048, 0)
    assert calls == [(2048, 4096, 1024)] * 24 + [(141, 1024, 1024)] * 24
    calls = C.stream_linear_calls(HP, ["conv_pw1_w"], 1024, 13)
    assert calls == [(1024 * 14, 2048, 1024)] * 24


def test_stream_attention_calls():
    # R=0: one T=1 attention a layer, every slot against 70 + 1 keys
    assert C.stream_attention_calls(HP, 2048, 0) == (24, (2048, 8, 71, 128))
    # R=13: 14 frames a chunk, matmul attention, no T=1 kernel
    assert C.stream_attention_calls(HP, 1024, 13) is None


def test_offline_segments():
    assert C.max_seg_mel_frames(HP) == 16376
    assert C.subsampled_len(16376) == 2048
    # 200 s: (3,200,000 + 256 - 512 + 160) // 160 = 19,999 mel frames,
    # segments of 16,376 and 3,623
    n = 200 * 16000
    assert C.mel_frames(n) == 19_999
    f1, f2 = C.subsampled_len(16376), C.subsampled_len(3623)
    assert (f1, f2) == (2048, 454)
    want = sum(f * C.frame_flops(HP) + 24 * 6 * 1024 * f * f
               + 24 * 2 * (2 * f - 1) * 1024 ** 2 for f in (f1, f2))
    want += (2100 + 500) * 1 * C.decode_iteration_flops(HP)
    assert C.offline_call_flops(HP, [n], 16376, [2100, 500]) == \
        pytest.approx(want)
