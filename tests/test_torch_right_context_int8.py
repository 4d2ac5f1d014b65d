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
the random weights flip under bf16 rounding)."""

import pytest
import torch

from test_torch_right_context import MODES, SEGMENTS, run_segment

from nemotron_tpu.ops import kvquant as jkv
from nemotron_tpu_torch.ops import kvquant as tkv

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
