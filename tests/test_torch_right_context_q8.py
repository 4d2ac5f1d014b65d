"""Right contexts 1, 6 and 13 with Q8_0 encoder matrices (the same quantized
bits in both packages; kernel B4's plain version on the CPU): the fused
tick of both packages in lockstep over the segments of
tests/test_torch_right_context.py at each mode's own n_phases, and the f32
serving form (Q8_0 + int8 K/V caches) at R=13. Tokens exactly equal, state
within 1e-4 (int8 codes within +-1). The quantized linears run at
M = B x chunk_len rows: the plans of kernels B4/B5 (bf16: gemm_plan; f32:
f32_plan) cover every output and K column once at those rows, ragged ones
included."""

import pytest
import torch

from test_torch_quant import MAIN_SHAPES, check_f32_plan, check_gemm_plan
from test_torch_right_context import MODES, SEGMENTS, run_segment

from nemotron_tpu_torch.ops import kvquant as tkv
from nemotron_tpu_torch.ops import quant as tq

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(SEGMENTS))
@pytest.mark.parametrize("mode", MODES)
def test_q8_tick_matches_jax(mode, name):
    run = run_segment(mode, name, quant_bits=8)
    assert tq.is_quantized(run.tm.params.layers.attn_q_w)


@pytest.mark.parametrize("name", list(SEGMENTS))
def test_q8_kv_int8_tick_matches_jax_at_r13(monkeypatch, name):
    monkeypatch.setenv("NEMOTRON_TPU_KV_INT8", "1")
    run = run_segment(13, name, quant_bits=8, kv_int8=True)
    assert tkv.is_quant(run.ts.k_cache)


# M = B x chunk_len: B=256 at right context 1 / 6 / 13, and the ragged
# B=3 (the CPU tests) and B=141 at 13
@pytest.mark.parametrize("m", [512, 1792, 3584, 42, 1974])
def test_plans_cover_the_right_context_rows(m):
    for n, k in MAIN_SHAPES:
        for sms in (132, 114, 78):
            for bits in (8, 4):
                check_gemm_plan(m, n, k, bits, sms)
            check_f32_plan(m, n, k, sms)
