"""basic, lstm and conv ops of the port against the JAX package's, on the same
numpy inputs; f32, atol 5e-5 (the same math, sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import rand, tiny_hparams

from nemotron_tpu.ops import basic as jb, conv as jc, lstm as jl
from nemotron_tpu.params import DecoderParams as JDec
from nemotron_tpu.params import random_params as j_random
from nemotron_tpu_torch.ops import basic as tb, conv as tc, lstm as tl
from nemotron_tpu_torch.params import DecoderParams as TDec
from nemotron_tpu_torch.params import random_params as t_random

torch.set_num_threads(1)
ATOL = 5e-5


def T(x):
    return torch.tensor(np.asarray(x))


def close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def test_basic_ops():
    x = rand(3, 5, 64, seed=1)
    w, b = rand(64, seed=2) + 1.0, rand(64, seed=3)
    close(tb.layer_norm(T(x), T(w), T(b)), jb.layer_norm(x, w, b))
    wl, bl = rand(48, 64, seed=4) * 0.1, rand(48, seed=5)
    close(tb.linear(T(x), T(wl), T(bl)), jb.linear(x, wl, bl))
    close(tb.linear(T(x), T(wl)), jb.linear(x, wl))
    w1, w2 = rand(96, 64, seed=6) * 0.1, rand(64, 96, seed=7) * 0.1
    close(tb.ffn(T(x), T(w1), T(w2)), jb.ffn(x, w1, w2))
    close(tb.glu(T(x)), jb.glu(x))


def test_lstm_cell_and_two_layer_step():
    H = 32
    x, h, c = rand(4, H, seed=1), rand(4, 2, H, seed=2), rand(4, 2, H, seed=3)
    dec = {"embedding": rand(5, H, seed=9),
           "w_ih": rand(2, 4 * H, H, seed=4) * 0.2,
           "w_hh": rand(2, 4 * H, H, seed=5) * 0.2,
           "b_ih": rand(2, 4 * H, seed=6), "b_hh": rand(2, 4 * H, seed=7)}
    jd = JDec(**{k: jnp.asarray(v) for k, v in dec.items()})
    td = TDec(**{k: T(v) for k, v in dec.items()})
    for got, want in zip(
            tl.lstm_cell(T(x), T(h[:, 0]), T(c[:, 0]), *(T(dec[k][0]) for k in
                         ("w_ih", "w_hh", "b_ih", "b_hh"))),
            jl.lstm_cell(x, h[:, 0], c[:, 0], *(dec[k][0] for k in
                         ("w_ih", "w_hh", "b_ih", "b_hh")))):
        close(got, want)
    for got, want in zip(tl.lstm2_step(td, T(x), T(h), T(c)),
                         jl.lstm2_step(jd, jnp.asarray(x), h, c)):
        close(got, want)


@pytest.mark.parametrize("depthwise", [False, True])
def test_causal_conv2d(depthwise):
    C = 8
    if depthwise:
        x = rand(2, 9, 16, C, seed=1)  # JAX NHWC
        w, b = rand(C, 1, 3, 3, seed=2), rand(C, seed=3)
        want = jc.causal_dw_conv2d(x, w, b, 2)
        got = tc.causal_dw_conv2d(T(x).permute(0, 3, 1, 2), T(w), T(b), 2)
    else:
        x = rand(2, 9, 16, 1, seed=1)
        w, b = rand(C, 1, 3, 3, seed=2), rand(C, seed=3)
        want = jc.causal_conv2d(x, w, b, 2)
        got = tc.causal_conv2d(T(x).permute(0, 3, 1, 2), T(w), T(b), 2)
    close(got.permute(0, 2, 3, 1), want)


def test_conv_subsampling_matches_including_flatten_order():
    hp = tiny_hparams()
    jp, tp = j_random(hp, seed=2), t_random(hp, seed=2, device="cpu")
    mel = rand(3, 17, hp.n_mels, seed=4)
    want = jc.conv_subsampling(jp.subsampling, jnp.asarray(mel))
    got = tc.conv_subsampling(tp.subsampling, T(mel))
    assert tuple(got.shape) == want.shape == (3, 3, hp.d_model)
    close(got, want)


@pytest.mark.parametrize("t, with_cache", [(1, True), (1, False), (4, True)])
def test_depthwise_causal_conv1d(t, with_cache):
    K, D = 5, 16
    x, w = rand(2, t, D, seed=1), rand(K, D, seed=2)
    cache = rand(2, K - 1, D, seed=3) if with_cache else None
    jy, jcache = jc.depthwise_causal_conv1d(
        x, w, None if cache is None else jnp.asarray(cache))
    ty, tcache = tc.depthwise_causal_conv1d(
        T(x), T(w), None if cache is None else T(cache))
    close(ty, jy)
    close(tcache, jcache)
