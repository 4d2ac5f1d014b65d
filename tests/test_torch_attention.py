"""T=1 attention: the port's plain t1_attention_core_ref against the Pallas
kernel (interpret mode) and against the JAX XLA path (_t1_scores /
_t1_context), and rel_pos_mha_fullbuf at T=1 against the JAX function.
atol 2e-5, the bound tests/test_modules.py uses between Pallas and XLA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemotron_tpu.models.encoder import _phase_attn_constants as j_consts
from nemotron_tpu.ops.attn_pallas import t1_attention_core as j_pallas
from nemotron_tpu.ops.rel_attention import _t1_context, _t1_scores
from nemotron_tpu.ops.rel_attention import rel_pos_mha_fullbuf as j_mha
from nemotron_tpu_torch.models.encoder import _phase_attn_constants as t_consts
from nemotron_tpu_torch.ops.attn_kernel import (t1_attention_core,
                                                t1_attention_core_ref)
from nemotron_tpu_torch.ops.rel_attention import rel_pos_mha_fullbuf as t_mha

torch.set_num_threads(1)
ATOL = 2e-5


def core_inputs(seed, B=4, H=4, S=12, Dh=16):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kn, vn = r(B, H, Dh), r(B, H, Dh), r(B, H, Dh)
    kb, vb = r(B, H, S, Dh), r(B, H, S, Dh)
    pm = (r(B, H, S + 1) * 0.25).astype(np.float32)
    for b in range(B):  # dead slots at -1e9; the new frame stays live
        pm[b, :, : b * 2] = -1e9
    return q, kn, vn, pm, kb, vb


def test_core_ref_matches_pallas_interpret():
    args = core_inputs(0)
    want = np.asarray(j_pallas(*map(jnp.asarray, args), interpret=True))
    got = t1_attention_core_ref(*map(torch.tensor, args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # on CPU tensors the kernel wrapper takes the plain version
    np.testing.assert_array_equal(
        t1_attention_core(*map(torch.tensor, args)).numpy(), got)


def test_core_ref_matches_xla_t1_path():
    q, kn, vn, pm, kb, vb = core_inputs(1)
    scale = 1.0 / np.sqrt(q.shape[-1])
    content = _t1_scores(jnp.asarray(q)[:, :, None], jnp.asarray(kb),
                         jnp.asarray(kn)[:, :, None])
    scores = content * scale + jnp.asarray(pm)[:, :, None, :]
    w = jax.nn.softmax(scores.astype(jnp.float32), axis=-1)
    want = np.asarray(_t1_context(w, jnp.asarray(vb),
                                  jnp.asarray(vn)[:, :, None]))[:, :, 0]
    got = t1_attention_core_ref(*map(torch.tensor, (q, kn, vn, pm, kb, vb)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_masked_slots_get_zero_weight():
    q, kn, vn, pm, kb, vb = core_inputs(2)
    vb2 = vb.copy()
    vb2[1, :, :2] = 1e6  # dead slots of stream 1 hold garbage
    a = t1_attention_core_ref(*map(torch.tensor, (q, kn, vn, pm, kb, vb)))
    b = t1_attention_core_ref(*map(torch.tensor, (q, kn, vn, pm, kb, vb2)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("phase", [0, 3, 8])
def test_phase_constants_match_jax_one_hot(phase):
    lc, s_buf = 8, 16
    jj, onehot = j_consts(lc, 1, s_buf, phase)
    tj, pos_index = t_consts(lc, 1, s_buf, phase)
    np.testing.assert_array_equal(tj, jj)
    live = pos_index[0] >= 0
    np.testing.assert_array_equal(live, onehot[0].sum(0) > 0)
    np.testing.assert_array_equal(pos_index[0][live],
                                  onehot[0].argmax(0)[live])


@pytest.mark.parametrize("phase", [0, 5])
def test_rel_pos_mha_fullbuf_t1_matches_jax(phase):
    rng = np.random.default_rng(3 + phase)
    B, H, Dh, lc, s_buf = 3, 4, 16, 8, 16
    D = H * Dh
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    x, pe = r(B, 1, D), r(2 * (lc + 1) - 1, D)
    ws = [r(D, D, sc=D ** -0.5) for _ in range(5)]
    bu, bv = r(H, Dh, sc=0.1), r(H, Dh, sc=0.1)
    kb, vb = r(B, H, s_buf, Dh), r(B, H, s_buf, Dh)
    valid = np.array([lc, 3, 0])
    jj, onehot = j_consts(lc, 1, s_buf, phase)
    mask = np.where(jj[None, :] < (lc - valid)[:, None], -1e9, 0.0
                    ).astype(np.float32)
    want = j_mha(jnp.asarray(x), jnp.asarray(pe), *map(jnp.asarray, ws),
                 jnp.asarray(bu), jnp.asarray(bv), H, Dh, jnp.asarray(kb),
                 jnp.asarray(vb), jnp.asarray(onehot), jnp.asarray(mask))
    _, pos_index = t_consts(lc, 1, s_buf, phase)
    got = t_mha(torch.tensor(x), torch.tensor(pe), *map(torch.tensor, ws),
                torch.tensor(bu), torch.tensor(bv), H, Dh, torch.tensor(kb),
                torch.tensor(vb), torch.tensor(pos_index),
                torch.tensor(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
