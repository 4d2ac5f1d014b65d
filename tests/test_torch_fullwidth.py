"""The streaming tick at the model's own geometry (Hparams() defaults: d_model
1024, 24 layers, vocabulary 1025, 128 mels) on the CPU, the JAX package
against the port on the same random weights (seed 0, the joint's blank bias
raised by BLANK_BIAS so that the random model emits ~2 tokens per frame):
four streams of seed-made audio, four fused ticks at right context 0, then
one masked tick; equal tokens, f32 caches within 1e-3.

Marked slow, outside tier-1: both packages hold 0.6B f32 weights (~2.5 GB
each) and the JAX package compiles a full-width tick per phase and mask,
minutes of one CPU core."""

import numpy as np
import pytest
import torch

from nemotron_tpu.api import ASRModel as JaxModel
from nemotron_tpu.config import Hparams as JaxHparams
from nemotron_tpu_torch.api import ASRModel as TorchModel
from nemotron_tpu_torch.config import Hparams
from nemotron_tpu_torch.streaming.engine import PRIME_SAMPLES, prime_carry
from nemotron_tpu_torch.streaming.state import state_leaves

torch.set_num_threads(1)

BLANK_BIAS = 2.4
N_TICKS = 4


def audio(n_streams, n_samples, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 16000.0
    out = np.empty((n_streams, n_samples), np.int16)
    for i in range(n_streams):
        sig = (0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t)
               + 0.1 * rng.standard_normal(n_samples))
        out[i] = (np.clip(sig, -1, 1) * 32767).astype(np.int16)
    return out


def run_ticks(model, pcm):
    """N_TICKS all-active fused ticks, then one with stream 1 paused (the
    masked fast path); returns (tokens [B, ticks, S], state)."""
    cfg = model.cache_config(0)
    b, shift = pcm.shape[0], cfg.shift_samples
    state = model.init_stream_state(b, cfg)
    tails, lasts = zip(*(prime_carry(a[:PRIME_SAMPLES]) for a in pcm))
    state = model.prime_frontend(state, np.ones(b, bool), np.stack(tails),
                                 np.asarray(lasts, np.float32))
    toks = []
    for i in range(N_TICKS + 1):
        active = None
        if i == N_TICKS:
            active = np.ones(b, bool)
            active[1] = False
        lo = PRIME_SAMPLES + i * shift
        packed = model.pack_tick_inputs(
            pcm[:, lo:lo + shift], np.full(b, cfg.valid_out_len, np.int16),
            np.zeros(b, np.int16), active)
        state, t = model.fused_tick_packed(
            cfg, state, model.put_batch(packed), active is None, phase=i,
            fast_gated=active is not None)
        toks.append(np.asarray(t.cpu() if isinstance(t, torch.Tensor)
                               else t))
    return np.concatenate(toks, axis=1), state


def check(hp_kw):
    """JAX vs the port at Hparams(**hp_kw)."""
    hp_t = Hparams(**hp_kw)
    jm = JaxModel.random(JaxHparams(**hp_kw), seed=0)
    jm.params.joint.out_b = jm.params.joint.out_b.at[hp_t.blank_id].add(
        BLANK_BIAS)
    tm = TorchModel.random(hp_t, seed=0, device="cpu")
    tm.params.joint.out_b[hp_t.blank_id] += BLANK_BIAS
    pcm = audio(4, PRIME_SAMPLES + (N_TICKS + 1) * 1280)
    j_tok, j_state = run_ticks(jm, pcm)
    del jm
    t_tok, t_state = run_ticks(tm, pcm)
    assert (j_tok >= 0).sum() > 0, "the random model emitted nothing"
    np.testing.assert_array_equal(t_tok, j_tok)
    diffs = {}
    for n, name in enumerate(("k_cache", "v_cache", "conv_cache")):
        got = state_leaves(t_state)[n].numpy()
        want = np.asarray(getattr(j_state, name))
        np.testing.assert_allclose(got, want, atol=1e-3)
        diffs[name] = float(np.abs(got - want).max())
    # the record of a run (pytest -s shows it)
    print(f"{hp_t.n_layers} layers: {int((t_tok >= 0).sum())} tokens, "
          f"equal; max |port - JAX| {diffs}")


@pytest.mark.slow
def test_full_width_ticks_match_jax():
    check({})
