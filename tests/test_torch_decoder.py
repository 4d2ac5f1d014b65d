"""The port's loop-labels greedy RNNT decode against the JAX package's: the
tokens exactly equal, the decoder state within 5e-5 (f32). The streaming
tick runs the loop's fixed bound instead of the JAX early exit, the
offline path blocks of iterations with the exit tested between them;
neither may change the tokens, and the exit must equal the fixed bound bit for bit and the JAX
package's frame-scan form too. With bf16 weights, encoder frames and state in both packages the
tokens are exactly equal too, and the state within 7.8e-3, one bf16 ulp of
a value in [1, 2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import rand, tiny_hparams

from nemotron_tpu.models import decoder as jd
from nemotron_tpu.params import random_params as j_random
from nemotron_tpu_torch.models import decoder as td
from nemotron_tpu_torch.params import random_params as t_random

torch.set_num_threads(1)


CASES = [
    (1, 0.0, [1, 1, 0, 1]),
    (1, -3.0, [1, 1, 1, 1]),   # blank suppressed: streams hit the 10-cap
    (4, 0.5, [4, 2, 0, 3]),
]


def check_decode(t, blank_bias, n_valid, bf16=False, atol=5e-5):
    hp = tiny_hparams()
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    jp, tp = j_random(hp, seed=5, dtype=jdt), t_random(hp, seed=5, dtype=tdt,
                                                     device="cpu")
    jp.joint.out_b = jp.joint.out_b.at[hp.blank_id].add(blank_bias)
    tp.joint.out_b[hp.blank_id] += blank_bias
    b = len(n_valid)
    enc = rand(b, t, hp.d_model, seed=6)
    h, c = rand(b, 2, hp.decoder_dim, seed=7), rand(b, 2, hp.decoder_dim, seed=8)
    prev = np.array([hp.blank_id, 3, 5, hp.blank_id], np.int32)
    off = np.array([0, 4, 9, 2], np.int32)
    js = jd.DecodeState(h=jnp.asarray(h, jdt), c=jnp.asarray(c, jdt),
                        prev_token=jnp.asarray(prev),
                        frame_offset=jnp.asarray(off))
    ts = td.DecodeState(h=torch.tensor(h).to(tdt), c=torch.tensor(c).to(tdt),
                        prev_token=torch.tensor(prev),
                        frame_offset=torch.tensor(off))
    nv = np.asarray(n_valid, np.int32)
    js2, jt = jd.greedy_decode(jp, hp, jnp.asarray(enc, jdt), js,
                               jnp.asarray(nv))
    ts2, tt = td.greedy_decode(tp, hp, torch.tensor(enc).to(tdt), ts,
                               torch.tensor(nv))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert (tt.numpy() >= 0).any()
    if blank_bias < 0:
        assert ((tt.numpy() >= 0).sum(-1) == 10).all()
    for name in ("h", "c"):
        assert getattr(ts2, name).dtype == tdt
        np.testing.assert_allclose(
            getattr(ts2, name).float().numpy(),
            np.asarray(getattr(js2, name)).astype(np.float32), atol=atol,
            rtol=0)
    for name in ("prev_token", "frame_offset"):
        np.testing.assert_array_equal(getattr(ts2, name).numpy(),
                                      np.asarray(getattr(js2, name)))


@pytest.mark.parametrize("t, blank_bias, n_valid", CASES)
def test_greedy_decode_tokens_equal(t, blank_bias, n_valid):
    check_decode(t, blank_bias, n_valid)


@pytest.mark.parametrize("t, blank_bias, n_valid", CASES)
def test_greedy_decode_bf16_tokens_equal(t, blank_bias, n_valid):
    check_decode(t, blank_bias, n_valid, bf16=True, atol=2.0 ** -7)


def test_init_state_and_joint_match():
    hp = tiny_hparams()
    js, ts = jd.init_decode_state(3, hp), td.init_decode_state(3, hp, device="cpu")
    for name in ("h", "c", "prev_token", "frame_offset"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    jp, tp = j_random(hp, seed=1), t_random(hp, seed=1, device="cpu")
    e, d = rand(3, hp.joint_dim, seed=2), rand(3, hp.decoder_dim, seed=3)
    np.testing.assert_allclose(
        td.joint_from_proj(tp.joint, torch.tensor(e), torch.tensor(d)).numpy(),
        np.asarray(jd.joint_from_proj(jp.joint, e, d)), atol=5e-5, rtol=0)


def test_argmax_ties_take_the_first_maximum():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]])
    assert torch.argmax(logits, dim=-1).tolist() == [1, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)).tolist() \
        == [1, 0]


def test_joint_step_and_packed_confidences_match(monkeypatch):
    """joint_step; the decode with packed confidences (tok + V * q) against
    JAX's under NEMOTRON_TPU_CONFIDENCE=1, equal values; unpack_tokens and
    tokens_to_list(vocab_size, with_conf) against JAX's."""
    from nemotron_tpu.models.asr import tokens_to_list as j_list
    from nemotron_tpu_torch.models.asr import tokens_to_list as t_list

    hp = tiny_hparams()
    jp, tp = j_random(hp, seed=5), t_random(hp, seed=5, device="cpu")
    e, d = rand(3, hp.d_model, seed=2), rand(3, hp.decoder_dim, seed=3)
    np.testing.assert_allclose(
        td.joint_step(tp.joint, torch.tensor(e), torch.tensor(d)).numpy(),
        np.asarray(jd.joint_step(jp.joint, e, d)), atol=5e-5, rtol=0)

    monkeypatch.setenv("NEMOTRON_TPU_CONFIDENCE", "1")
    enc = rand(3, 4, hp.d_model, seed=6)
    nv = np.array([4, 2, 3], np.int32)
    js2, jt = jd.greedy_decode(jp, hp, jnp.asarray(enc),
                               jd.init_decode_state(3, hp), jnp.asarray(nv))
    ts2, tt = td.greedy_decode(tp, hp, torch.tensor(enc),
                               td.init_decode_state(3, hp, device="cpu"), torch.tensor(nv),
                               confidence=True)
    jt = np.asarray(jt)
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert (jt >= hp.vocab_size).any()  # confidences were packed
    for g, w in zip(td.unpack_tokens(tt.numpy(), hp.vocab_size),
                    jd.unpack_tokens(jt, hp.vocab_size)):
        np.testing.assert_array_equal(g, w)
    assert t_list(tt, nv, vocab_size=hp.vocab_size, with_conf=True) \
        == j_list(jt, nv, vocab_size=hp.vocab_size, with_conf=True)
    plain = td.greedy_decode(tp, hp, torch.tensor(enc),
                             td.init_decode_state(3, hp, device="cpu"), torch.tensor(nv))[1]
    assert t_list(plain, nv) == [[(tok % hp.vocab_size, t) for tok, t in seq]
                                 for seq in t_list(tt, nv)]


# (T, blank bias, n_valid): ragged, a stream with no frame, the 10-symbol
# cap hit on every frame, and a batch with no frame at all
EXIT_CASES = [
    (6, 0.5, [6, 2, 0, 5]),
    (5, -3.0, [5, 3, 1, 0]),
    (3, 2.0, [0, 0, 0, 0]),
]


@pytest.mark.parametrize("t, blank_bias, n_valid", EXIT_CASES)
@pytest.mark.parametrize("exit_every", [1, 16])
def test_decode_exit_equals_the_fixed_bound_and_both_jax_forms(
        monkeypatch, t, blank_bias, n_valid, exit_every):
    """The offline path's decode, in blocks of exit_every iterations on a
    carry (decode_block, the exit tested between blocks by
    decode_in_blocks), against greedy_decode's fixed bound (its
    iterations counted: t*11+1): tokens and state bit-equal, in fewer iterations where streams blank early (tested
    every iteration), never more than a block past the bound; and against
    the JAX package's loop-labels form and its frame-scan form
    (LOOP_LABELS off): tokens equal, state within 5e-5."""
    hp = tiny_hparams()
    jp, tp = j_random(hp, seed=9), t_random(hp, seed=9, device="cpu")
    jp.joint.out_b = jp.joint.out_b.at[hp.blank_id].add(blank_bias)
    tp.joint.out_b[hp.blank_id] += blank_bias
    b = len(n_valid)
    enc = rand(b, t, hp.d_model, seed=10)
    h, c = rand(b, 2, hp.decoder_dim, seed=11), rand(b, 2, hp.decoder_dim,
                                                     seed=12)
    prev = np.array([hp.blank_id, 3, 5, 7], np.int32)
    off = np.array([0, 4, 9, 2], np.int32)
    nv = np.asarray(n_valid, np.int32)

    def state():
        return td.DecodeState(h=torch.tensor(h), c=torch.tensor(c),
                              prev_token=torch.tensor(prev),
                              frame_offset=torch.tensor(off))

    # the loop's iterations, counted where each one runs
    ran = []
    step = td._iteration
    monkeypatch.setattr(td, "_iteration",
                        lambda *a, **k: ran.append(1) or step(*a, **k))
    fixed, fixed_tok = td.greedy_decode(tp, hp, torch.tensor(enc), state(),
                                        torch.tensor(nv))
    fixed_tok, n_fixed = fixed_tok.numpy(), len(ran)
    assert n_fixed == t * 11 + 1
    carry = td.init_carry(b, t + 3, hp, device="cpu")  # frames past t unused
    carry.enc_proj.fill_(7.0)
    carry.enc_proj[:, :t] = td.enc_projection(tp.joint, torch.tensor(enc))
    td.start_carry(carry, state(), torch.tensor(nv))
    n_exit = td.decode_in_blocks(
        carry, t, int(nv.max()), exit_every,
        lambda: td.decode_block(tp, hp, carry, exit_every))
    st, tok = td.carry_result(carry, state(), torch.tensor(nv), t)
    tok = tok.numpy()
    assert n_exit % exit_every == 0 and len(ran) - n_fixed == n_exit
    np.testing.assert_array_equal(tok, fixed_tok)
    for name in ("h", "c", "prev_token", "frame_offset"):
        assert torch.equal(getattr(st, name), getattr(fixed, name)), name
    emitted = (tok >= 0).sum()
    if blank_bias < 0:  # every frame of every stream at the cap
        assert ((tok >= 0).sum(-1) == 10 * (np.arange(t) < nv[:, None])
                ).all()
    if not nv.any():
        assert n_exit == 0 and emitted == 0
    elif blank_bias > 0 and exit_every == 1:
        assert n_exit < n_fixed and emitted
    # a stream takes an iteration per frame and per emission
    least = (nv + (tok >= 0).sum(axis=(1, 2))).max()
    assert least <= n_exit < n_fixed + exit_every

    js = jd.DecodeState(h=jnp.asarray(h), c=jnp.asarray(c),
                        prev_token=jnp.asarray(prev),
                        frame_offset=jnp.asarray(off))
    for loop_labels in (True, False):
        monkeypatch.setattr(jd, "LOOP_LABELS", loop_labels)
        js2, jt = jd.greedy_decode(jp, hp, jnp.asarray(enc), js,
                                   jnp.asarray(nv))
        np.testing.assert_array_equal(tok, np.asarray(jt))
        for name in ("h", "c"):
            np.testing.assert_allclose(
                getattr(st, name).numpy(), np.asarray(getattr(js2, name)),
                atol=5e-5, rtol=0)
        for name in ("prev_token", "frame_offset"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(js2, name)))
