"""The slice as a whole: the port's fused serving tick against the JAX
package's, both driven through ASRModel.fused_tick_packed as the engine
drives them, over multi-chunk R=0 streams. Covered: the slack-buffer wrap,
a k=8 chunk-loop tick, masked ticks with realign-on-resume (positive and
negative delta), masked wrap compaction, and a finalize tick with a
zero-padded block and a row decoding n_valid=0.

Tokens must be exactly equal; state leaves within 1e-4 (f32, sums in
another order).

bf16 runs the same schedule with bf16 weights in both packages. Their bf16
results cannot be bit-equal: XLA keeps f32 precision inside a fusion while
eager PyTorch rounds to bf16 after every op, and the argmaxes of these
random weights are near ties (the port and JAX flip one on 5 of the 19
ticks even when both start each tick from the same state). So in bf16 the leaves that no
token feeds back into (K/V and conv caches, frontend carries, cache
validity) must lie within 4 bf16 ulps of the leaf's largest magnitude
(2^-5 x max|leaf|); JAX's own bf16 state lies up to 0.032 from its f32
state here, and the port's lies as far from JAX's bf16 state. The bf16
case is tests/test_torch_tick_bf16.py; the bf16 decoder is held token for
token in tests/test_torch_decoder.py.

The harness also runs weight-only quantized encoders (Q8_0 / Q4_0, the same
quantized bits in both packages) and int8 K/V caches, whose codes may differ
by one where a value sits on a rounding boundary: codes are held within +-1
(tests/test_torch_quant.py, tests/test_torch_kv_int8.py). Those cases run
the schedule in five short segments, each from a fresh state at its own
starting phase (SEGMENTS below), so that each test stays short."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from helpers import tiny_hparams

from nemotron_tpu.api import ASRModel as JaxModel
from nemotron_tpu.models.asr import tokens_to_list as j_tokens_to_list
from nemotron_tpu.params import quantize_encoder_layers as j_quantize
from nemotron_tpu_torch.api import ASRModel as TorchModel
from nemotron_tpu_torch.models.asr import tokens_to_list
from nemotron_tpu_torch.params import quantize_encoder_layers
from nemotron_tpu_torch.shared.config import CacheConfig
from nemotron_tpu_torch.streaming.engine import PRIME_SAMPLES, prime_carry

torch.set_num_threads(1)

B = 3
ATOL = 1e-4
BF16_REL = 2.0 ** -5  # 4 bf16 ulps at the leaf's largest magnitude
ENCODER_LEAVES = ("k_cache", "v_cache", "conv_cache", "cache_valid",
                  "pp_tail", "pp_last", "mel_ov")


def leaves(state):
    """{name: f32 numpy} over a state; an int8 cache gives two leaves,
    `<name>.q` (codes) and `<name>.s` (per-frame scales)."""
    d = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "decode":
            d.update({"decode." + g.name: getattr(v, g.name)
                      for g in dataclasses.fields(v)})
        elif hasattr(v, "q"):  # QuantKV of either package
            d.update({f.name + ".q": v.q, f.name + ".s": v.s})
        else:
            d[f.name] = v
    return {k: (v.cpu().float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v).astype(np.float32)) for k, v in d.items()}


def assert_states_close(js, ts, where, bf16=False):
    jl, tl = leaves(js), leaves(ts)
    assert jl.keys() == tl.keys()
    for k in jl:
        assert jl[k].shape == tl[k].shape, (where, k)
        assert np.isfinite(tl[k]).all(), (where, k)
        if bf16 and k.split(".")[0] not in ENCODER_LEAVES:
            continue
        if bf16:
            atol = BF16_REL * np.abs(jl[k]).max()
        else:  # int8 codes within +-1
            atol = 1.0 if k.endswith(".q") else ATOL
        np.testing.assert_allclose(tl[k], jl[k], atol=atol, rtol=0,
                                   err_msg=f"{where}: {k}")


class Lockstep:
    """Both packages' states advanced tick by tick with the engine's phase
    bookkeeping (slot phases, realign on resume, masked wrap compaction)."""

    def __init__(self, audio, bf16=False, quant_bits=None, kv_int8=False,
                 phase=0):
        """quant_bits: Q8_0 (8) or Q4_0 (4) encoder matrices in both
        packages. kv_int8: int8 K/V caches; the JAX package reads its
        NEMOTRON_TPU_KV_INT8 at state allocation, so the caller sets it.
        phase: the group's starting phase (a fresh state is aligned at any
        phase)."""
        hp = tiny_hparams()
        self.bf16 = bf16
        self.jm = JaxModel.random(
            hp, seed=1, dtype=jnp.bfloat16 if bf16 else jnp.float32)
        self.tm = TorchModel.random(
            hp, seed=1, dtype=torch.bfloat16 if bf16 else torch.float32,
            kv_int8=kv_int8)
        if quant_bits:
            self.jm.params = j_quantize(self.jm.params, bits=quant_bits)
            self.tm.params = quantize_encoder_layers(self.tm.params,
                                                     bits=quant_bits)
        self.cfg = self.tm.cache_config(0)
        assert dataclasses.asdict(self.cfg) \
            == dataclasses.asdict(self.jm.cache_config(0))
        self.audio, self.pos = audio, np.full(B, PRIME_SAMPLES)
        self.js = self.jm.init_stream_state(B, self.cfg)
        self.ts = self.tm.init_stream_state(B, self.cfg)
        tails, lasts = zip(*(prime_carry(a[:PRIME_SAMPLES]) for a in audio))
        args = (np.ones(B, bool), np.stack(tails), np.asarray(lasts, np.float32))
        self.js = self.jm.prime_frontend(self.js, *args)
        self.ts = self.tm.prime_frontend(self.ts, *args)
        self.phase = phase
        self.slot_phase = np.full(B, phase)
        self.ids = [[], [], []]
        self.n_ticks = 0

    def tick(self, active=None, k=1, n_valid=None, partial=None):
        cfg, shift = self.cfg, self.cfg.shift_samples
        act = np.ones(B, bool) if active is None else np.asarray(active)
        if active is not None:  # realign-on-resume
            for d in sorted({self.phase - p for p in self.slot_phase[act]} - {0}):
                m = act & (self.phase - self.slot_phase == d)
                self.js = self.jm.realign_state(cfg, self.js, d, m)
                self.ts = self.tm.realign_state(cfg, self.ts, d, m)
                self.slot_phase[m] = self.phase
        block = np.zeros((B, k * shift), np.int16)
        for i in np.nonzero(act)[0]:
            n = k * shift if partial is None or i not in partial else partial[i]
            block[i, :n] = self.audio[i, self.pos[i]:self.pos[i] + n]
            self.pos[i] += n
        nv = np.where(act, cfg.valid_out_len, 0) if n_valid is None else n_valid
        packed = self.tm.pack_tick_inputs(block, nv, np.zeros(B),
                                          None if active is None else act)
        self.js, jt = self.jm.fused_tick_packed(
            cfg, self.js, jnp.asarray(packed), active is None, phase=self.phase,
            k=k, fast_gated=active is not None)
        self.ts, tt = self.tm.fused_tick_packed(
            cfg, self.ts, self.tm.put_batch(packed), active is None,
            phase=self.phase, k=k, fast_gated=active is not None)
        jt, tt = np.asarray(jt), tt.numpy()
        assert tt.shape == jt.shape and tt.max() < self.tm.hp.vocab_size
        if not self.bf16:
            np.testing.assert_array_equal(tt, jt, err_msg=f"tick {self.n_ticks}")
            assert tokens_to_list(torch.tensor(tt), nv) \
                == j_tokens_to_list(jt, nv)
        for i in range(B):
            self.ids[i].extend(int(t) for t in tt[i].flatten() if t >= 0)
        self.n_ticks += 1
        if k > 1:  # wrap compaction ran inside the k-chunk tick
            self.phase = (self.phase + k) % cfg.n_phases
            self.slot_phase[:] = self.phase
            return
        self.slot_phase[act] = self.phase + 1
        self.phase += 1
        if self.phase == cfg.n_phases:
            aligned = self.slot_phase == cfg.n_phases
            mask = None if aligned.all() else aligned
            self.js = self.jm.compact_state(cfg, self.js, mask=mask)
            self.ts = self.tm.compact_state(cfg, self.ts, mask=mask)
            self.slot_phase[aligned] = 0
            self.phase = 0


def make_audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    out = np.empty((B, n), np.int16)
    for i in range(B):
        sig = (0.35 * np.sin(2 * np.pi * (200 + 70 * i) * t)
               + 0.2 * rng.standard_normal(n))
        out[i] = (np.clip(sig, -1, 1) * 32767).astype(np.int16)
    return out


def run_schedule(run, bf16=False):
    """8 ticks to the first wrap, a k=8 tick, masked ticks with realign
    (+3 and -6), a masked wrap compaction and a finalize; the states are
    compared at four points."""
    for _ in range(8):                    # phases 0..7, then the wrap
        run.tick()
    assert_states_close(run.js, run.ts, "after the first wrap", bf16)
    run.tick(k=8)                         # k=8 chunk loop, wrap inside
    assert run.phase == 0
    paused1 = np.array([True, False, True])
    for _ in range(3):                    # stream 1 paused at phase 0
        run.tick(active=paused1)
    run.tick(active=np.ones(B, bool))     # resume: realign delta +3
    for _ in range(2):
        run.tick()
    assert_states_close(run.js, run.ts, "after realign +3", bf16)
    paused2 = np.array([True, True, False])
    run.tick(active=paused2)              # phase 6, stream 2 paused
    run.tick(active=paused2)              # phase 7 -> masked wrap compaction
    assert run.phase == 0 and run.slot_phase[2] == 6
    run.tick(active=np.ones(B, bool))     # resume: realign delta -6
    # finalize: stream 0 sends a zero-padded partial block, stream 1 is
    # active but decodes nothing (n_valid 0), stream 2 is idle
    run.tick(active=np.array([True, True, False]),
             n_valid=np.array([1, 0, 0]), partial={0: 500})
    assert_states_close(run.js, run.ts, "after finalize", bf16)
    assert run.n_ticks == 19
    assert all(run.ids), run.ids          # every stream emitted tokens


def _wrap(run):
    """From phase n_phases - 2: two ticks to the wrap compaction."""
    run.tick()
    run.tick()
    assert run.phase == 0


def _k8(run):
    """From phase 0: one k=8 chunk-loop tick, its wrap inside."""
    run.tick(k=8)
    assert run.phase == 0


def _masked_realign(run):
    """From phase 0: stream 1 paused for two ticks, then realign +2."""
    paused = np.array([True, False, True])
    run.tick(active=paused)
    run.tick(active=paused)
    run.tick(active=np.ones(B, bool))     # resume: realign delta +2


def _masked_wrap(run):
    """From phase n_phases - 2: stream 2 paused through a masked wrap
    compaction, then realign -(n_phases - 2) on resume."""
    start = run.phase
    paused = np.array([True, True, False])
    run.tick(active=paused)
    run.tick(active=paused)               # masked wrap compaction
    assert run.phase == 0 and run.slot_phase[2] == start
    run.tick(active=np.ones(B, bool))     # resume: realign delta -start


def _finalize(run):
    """From phase 0: a tick, then stream 0 finalizes with a zero-padded
    partial block, stream 1 decodes n_valid 0, stream 2 is idle."""
    run.tick()
    run.tick(active=np.array([True, True, False]),
             n_valid=np.array([1, 0, 0]), partial={0: 500})


# name -> (starting phase as an offset from n_phases, or 0; the segment)
SEGMENTS = {"wrap": (-2, _wrap), "k8": (0, _k8),
            "masked_realign": (0, _masked_realign),
            "masked_wrap": (-2, _masked_wrap), "finalize": (0, _finalize)}


def run_segment(name, **kw):
    """One schedule segment from a fresh lockstep state; returns the run."""
    offset, seg = SEGMENTS[name]
    n_phases = CacheConfig.for_mode(0, tiny_hparams()).n_phases
    run = Lockstep(make_audio(PRIME_SAMPLES + 10 * 1280, seed=5),
                   phase=offset % n_phases, **kw)
    seg(run)
    assert_states_close(run.js, run.ts, f"after {name}", run.bf16)
    assert any(run.ids), run.ids          # the segment emitted tokens
    return run


def test_fused_tick_matches_jax_over_multichunk_streams():
    run_schedule(Lockstep(make_audio(PRIME_SAMPLES + 40 * 1280, seed=5)))
