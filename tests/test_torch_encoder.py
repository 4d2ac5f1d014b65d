"""The port's streaming encoder against the JAX package's: stream_encode_step
over phases 0..n_phases with the wrap compaction, the masked fast path,
realign-on-resume and masked / mid-cycle compaction; atol 1e-4.

The port writes the caches in place, so every comparison hands each package
its own copy of the state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import rand, tiny_cfg, tiny_hparams

from nemotron_tpu.models import encoder as je
from nemotron_tpu.params import random_params as j_random
from nemotron_tpu_torch.models import encoder as te
from nemotron_tpu_torch.params import random_params as t_random

torch.set_num_threads(1)
ATOL = 1e-4
B = 3


@pytest.fixture(scope="module")
def setup():
    hp = tiny_hparams()
    cfg = tiny_cfg(hp)
    return hp, cfg, j_random(hp, seed=2), t_random(hp, seed=2, device="cpu")


def caches(hp, cfg, seed):
    s = cfg.cache_buf_len(hp)
    k = rand(hp.n_layers, B, hp.n_heads, s, hp.d_head, seed=seed)
    v = rand(hp.n_layers, B, hp.n_heads, s, hp.d_head, seed=seed + 1)
    c = rand(hp.n_layers, B, cfg.conv_cache_size, hp.d_model, seed=seed + 2)
    return k, v, c


def close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=what)


def test_stream_encode_over_phases_with_wrap(setup):
    hp, cfg, jp, tp = setup
    k, v, c = caches(hp, cfg, seed=1)
    jk, jv, jc, jvalid = map(jnp.asarray, (k, v, c, np.array([0, 3, 8], np.int32)))
    tk, tv, tc = map(torch.tensor, (k, v, c))
    tvalid = torch.tensor([0, 3, 8], dtype=torch.int32)
    for step in range(cfg.n_phases + 2):
        phase = step % cfg.n_phases
        mel = rand(B, cfg.chunk_mel_frames, hp.n_mels, seed=10 + step)
        jx, jk, jv, jc, jvalid = je.stream_encode_step(
            jp, hp, cfg, jnp.asarray(mel), jk, jv, jc, jvalid, phase=phase)
        tx, tk, tv, tc, tvalid = te.stream_encode_step(
            tp, hp, cfg, torch.tensor(mel), tk, tv, tc, tvalid, phase=phase)
        close(tx, jx, f"enc step {step}")
        if phase + 1 == cfg.n_phases:
            jk, jv = je.compact_cache(cfg, hp, jk, jv)
            tk, tv = te.compact_cache(cfg, hp, tk, tv)
        for name, g, w in (("k", tk, jk), ("v", tv, jv), ("conv", tc, jc)):
            close(g, w, f"{name} step {step}")
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("phase", [0, 4])
def test_masked_fast_path_keeps_inactive_slots(setup, phase):
    hp, cfg, jp, tp = setup
    k, v, c = caches(hp, cfg, seed=20)
    valid = np.array([5, 8, 2], np.int32)
    active = np.array([True, False, True])
    mel = rand(B, cfg.chunk_mel_frames, hp.n_mels, seed=21)
    jx, jk, jv, jc, jvalid = je.stream_encode_step(
        jp, hp, cfg, jnp.asarray(mel), *map(jnp.asarray, (k, v, c, valid)),
        phase=phase, active_mask=jnp.asarray(active))
    tx, tk, tv, tc, tvalid = te.stream_encode_step(
        tp, hp, cfg, torch.tensor(mel), *map(torch.tensor, (k, v, c, valid)),
        phase=phase, active_mask=torch.tensor(active))
    close(tx, jx, "enc")
    for name, g, w in (("k", tk, jk), ("v", tv, jv), ("conv", tc, jc)):
        close(g, w, name)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    # the paused slot is untouched bit for bit
    np.testing.assert_array_equal(tk[:, 1].numpy(), k[:, 1])
    np.testing.assert_array_equal(tc[:, 1].numpy(), c[:, 1])


@pytest.mark.parametrize("delta", [3, -5])
def test_realign_rolls_only_masked_slots(setup, delta):
    hp, cfg, _, _ = setup
    k, v, _ = caches(hp, cfg, seed=30)
    mask = np.array([False, True, True])
    jk, jv = je.realign_cache(cfg, hp, jnp.asarray(k), jnp.asarray(v), delta,
                              jnp.asarray(mask))
    tk, tv = te.realign_cache(cfg, hp, torch.tensor(k), torch.tensor(v), delta,
                              torch.tensor(mask))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk[:, 0].numpy(), k[:, 0])


@pytest.mark.parametrize("phase, masked", [(None, False), (None, True),
                                           (3, False), (5, True), (0, False)])
def test_compaction_wrap_mid_cycle_and_masked(setup, phase, masked):
    hp, cfg, _, _ = setup
    k, v, _ = caches(hp, cfg, seed=40)
    mask = np.array([True, False, True]) if masked else None
    jk, jv = je.compact_cache(cfg, hp, jnp.asarray(k), jnp.asarray(v),
                              phase=phase,
                              mask=None if mask is None else jnp.asarray(mask))
    tk, tv = te.compact_cache(cfg, hp, torch.tensor(k), torch.tensor(v),
                              phase=phase,
                              mask=None if mask is None else torch.tensor(mask))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_pos_emb_slice_matches(setup):
    hp, _, jp, tp = setup
    np.testing.assert_array_equal(te.pos_emb_slice(tp.pos_emb, 17).numpy(),
                                  np.asarray(je.pos_emb_slice(jp.pos_emb, 17)))


def test_stream_encode_with_language_prompt_fusion():
    hp = tiny_hparams(num_prompts=8)
    cfg = tiny_cfg(hp)
    jp, tp = j_random(hp, seed=6), t_random(hp, seed=6, device="cpu")
    k, v, c = caches(hp, cfg, seed=50)
    valid = np.array([8, 1, 4], np.int32)
    mel = rand(B, cfg.chunk_mel_frames, hp.n_mels, seed=51)
    onehot = np.eye(8, dtype=np.float32)[[0, 5, 7]]
    jx = je.stream_encode_step(
        jp, hp, cfg, jnp.asarray(mel), *map(jnp.asarray, (k, v, c, valid)),
        prompt_onehot=jnp.asarray(onehot), phase=2)[0]
    tx = te.stream_encode_step(
        tp, hp, cfg, torch.tensor(mel), *map(torch.tensor, (k, v, c, valid)),
        prompt_onehot=torch.tensor(onehot), phase=2)[0]
    close(tx, jx, "enc with prompt")
