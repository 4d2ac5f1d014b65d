"""Parameters: the port's random_params and GGUF loader against the JAX
package's, leaf for leaf (exact: both draw or decode the same f32 values).
The two packages' Hparams are distinct classes with the same fields (the
port keeps its own copy of config.py, nemotron_tpu_torch/config.py), so they
are compared field by field."""

import dataclasses

import numpy as np
import pytest
import torch

from helpers import tiny_hparams
from scripts_support import export_random_checkpoint

from nemotron_tpu import params as jparams
from nemotron_tpu.gguf.reader import GGML_F16, GGML_F32
from nemotron_tpu_torch import params as tparams

torch.set_num_threads(1)


def flat(tree, prefix=""):
    """{dotted name: numpy array} over a params dataclass tree."""
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out.update(flat(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = np.asarray(
                v.cpu() if isinstance(v, torch.Tensor) else v)
    return out


def assert_trees_equal(jtree, ttree):
    jl, tl = flat(jtree), flat(ttree)
    assert jl.keys() == tl.keys()
    for k in jl:
        assert jl[k].shape == tl[k].shape, k
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)


@pytest.mark.parametrize("overrides", [{}, {"num_prompts": 8}])
def test_random_params_equal_leaf_for_leaf(overrides):
    hp = tiny_hparams(**overrides)
    assert_trees_equal(jparams.random_params(hp, seed=3),
                       tparams.random_params(hp, seed=3, device="cpu"))


def test_params_from_numpy_bridge_copies():
    hp = tiny_hparams()
    jp = jparams.random_params(hp, seed=4)
    tp = tparams.params_from_numpy(jp, device="cpu")
    assert_trees_equal(jp, tp)
    tp.layers.attn_q_w.zero_()  # in-place on the port's copy only
    assert np.abs(np.asarray(jp.layers.attn_q_w)).sum() > 0
    bf = tparams.params_to(tp, dtype=torch.bfloat16)
    assert bf.layers.ffn1_w1.dtype == torch.bfloat16
    assert bf.preproc.filterbank.dtype == torch.float32  # frontend stays f32


@pytest.mark.parametrize("f16", [False, True])
def test_gguf_loads_identically(tmp_path, f16):
    hp = tiny_hparams()
    path = str(tmp_path / "tiny.gguf")
    names = export_random_checkpoint(hp, path, seed=7)
    types = ({n: GGML_F16 for n in names if n.startswith("encoder.layers.")}
             if f16 else None)
    if types:
        export_random_checkpoint(hp, path, seed=7, tensor_types=types)
    jhp, jp, jmeta = jparams.load_model(path)
    thp, tp, tmeta = tparams.load_model(path, device="cpu")
    assert dataclasses.asdict(jhp) == dataclasses.asdict(thp)
    assert jmeta["vocab"] == tmeta["vocab"] and len(tmeta["vocab"]) == 32
    assert_trees_equal(jp, tp)


def test_hparams_and_conv_normalization_match():
    kv = {"nemo.d_model": 256, "nemo.n_heads": 4, "nemo.n_layers": 3}
    assert dataclasses.asdict(tparams.hparams_from_kv(kv)) \
        == dataclasses.asdict(jparams.hparams_from_kv(kv))
    rng = np.random.default_rng(0)
    for name, shape in (("x.conv.depthwise_conv.weight", (6, 1, 5)),
                        ("x.conv.pointwise_conv1.weight", (12, 6, 1)),
                        ("x.other.weight", (3, 4))):
        arr = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(
            tparams._normalize_conv_weights(name, arr),
            jparams._normalize_conv_weights(name, arr))
    fb = rng.uniform(size=(1, 8, 257)).astype(np.float32)
    np.testing.assert_array_equal(tparams.norm_featurizer_fb(fb),
                                  jparams.norm_featurizer_fb(fb))
    np.testing.assert_array_equal(tparams.compute_pos_emb(64, 32),
                                  jparams.compute_pos_emb(64, 32))


def test_layer_slice_is_a_view():
    tp = tparams.random_params(tiny_hparams(), seed=0, device="cpu")
    lp = tparams.layer_slice(tp.layers, 1)
    assert lp.attn_q_w.data_ptr() == tp.layers.attn_q_w[1].data_ptr()


@pytest.mark.parametrize("f16", [False, True])
def test_save_gguf_round_trips_through_both_loaders(tmp_path, f16):
    """The port's GGUF writer: what it writes loads back leaf for leaf in
    the port and in the JAX package (F16 matrices rounded once). The file
    holds no max_pos_len, so the loaders' own default builds pos_emb."""
    hp = tiny_hparams(num_prompts=4)
    tp = tparams.random_params(hp, seed=5, device="cpu")
    vocab = [f"▁v{i}" for i in range(hp.vocab_size - 1)]
    path = str(tmp_path / "saved.gguf")
    tparams.save_gguf(path, hp, tp, vocab,
                      GGML_F16 if f16 else GGML_F32,
                      prompt_dict={"en-US": 0, "de-DE": 1})
    thp, back, meta = tparams.load_model(path, device="cpu")
    jhp, jp, jmeta = jparams.load_model(path)
    assert dataclasses.asdict(thp) == dataclasses.asdict(
        dataclasses.replace(hp, max_pos_len=thp.max_pos_len))
    assert meta["vocab"] == vocab == jmeta["vocab"]
    assert meta["prompt_dict"] == {"en-US": 0, "de-DE": 1}
    assert_trees_equal(jp, back)
    want, got = flat(tp), flat(back)
    del want["pos_emb"]
    for k in want:
        w = want[k]
        if f16 and w.ndim >= 2 and not k.startswith("preproc"):
            w = w.astype(np.float16).astype(np.float32)
        np.testing.assert_array_equal(got[k], w, err_msg=k)
