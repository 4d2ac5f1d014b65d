"""The slice as a whole in bf16: the schedule of test_torch_tick.py (wrap,
k=8, masked ticks with realign, masked wrap, finalize) with bf16 weights in
both packages. The leaves no token feeds back into lie within 4 bf16 ulps
of the leaf's largest magnitude; tokens are not compared (near-tie argmaxes
flip under bf16 rounding, see test_torch_tick.py)."""

import torch

from test_torch_tick import Lockstep, make_audio, run_schedule

from nemotron_tpu_torch.streaming.engine import PRIME_SAMPLES

torch.set_num_threads(1)


def test_fused_tick_bf16_state_within_bound():
    run = Lockstep(make_audio(PRIME_SAMPLES + 40 * 1280, seed=5), bf16=True)
    run_schedule(run, bf16=True)
    assert run.ts.k_cache.dtype == torch.bfloat16
    assert run.ts.pp_tail.dtype == torch.float32  # the frontend stays f32
