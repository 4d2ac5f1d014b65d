"""Parameter dataclasses of tensors (port of nemotron_tpu/params.py).

Same fields, shapes and orientation as the JAX package's pytrees, so the two
can be compared leaf by leaf: the conformer layers are stacked on a leading
[L] axis and linear weights keep PyTorch (out, in) order. `random_params`
draws the same numpy stream in the same order as the JAX package, so
`ASRModel.random()` gives identical weights in both.

A stacked layer field may also be a weight-only quantized matrix
(`ops.quant.QuantizedTensor` / `QuantizedTensor4`, with the same leading
[L] axis): `quantize_encoder_layers` makes them from dense weights, and
`load_model(keep_quantized=True)` keeps a Q8_0 / Q4_0 checkpoint's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.quant import (QuantizedTensor, QuantizedTensor4, from_gguf_q4,
                        from_gguf_q8, is_quantized, quantize_q4, quantize_q8)
from .shared.config import Hparams
from .shared.gguf import GGML_Q4_0, GGML_Q8_0, read_gguf


@dataclasses.dataclass
class SubsamplingParams:
    conv0_w: torch.Tensor  # (C, 1, 3, 3)   full conv, stride 2
    conv0_b: torch.Tensor  # (C,)
    conv2_w: torch.Tensor  # (C, 1, 3, 3)   depthwise, stride 2
    conv2_b: torch.Tensor
    conv3_w: torch.Tensor  # (C, C, 1, 1)   pointwise
    conv3_b: torch.Tensor
    conv5_w: torch.Tensor  # (C, 1, 3, 3)   depthwise, stride 2
    conv5_b: torch.Tensor
    conv6_w: torch.Tensor  # (C, C, 1, 1)   pointwise
    conv6_b: torch.Tensor
    out_w: torch.Tensor    # (d_model, flat_dim)
    out_b: torch.Tensor    # (d_model,)


@dataclasses.dataclass
class ConformerLayerParams:
    """Conformer layers; in the model every field carries a leading [L] axis."""

    norm_ff1_w: torch.Tensor
    norm_ff1_b: torch.Tensor
    ffn1_w1: torch.Tensor      # (d_ff, d_model)
    ffn1_w2: torch.Tensor      # (d_model, d_ff)
    norm_attn_w: torch.Tensor
    norm_attn_b: torch.Tensor
    attn_q_w: torch.Tensor     # (d_model, d_model)
    attn_k_w: torch.Tensor
    attn_v_w: torch.Tensor
    attn_pos_w: torch.Tensor
    attn_out_w: torch.Tensor
    pos_bias_u: torch.Tensor   # (n_heads, d_head)
    pos_bias_v: torch.Tensor
    norm_conv_w: torch.Tensor
    norm_conv_b: torch.Tensor
    conv_pw1_w: torch.Tensor   # (2*d_model, d_model)
    conv_dw_w: torch.Tensor    # (kernel_size, d_model), kernel-major
    conv_ln_w: torch.Tensor
    conv_ln_b: torch.Tensor
    conv_pw2_w: torch.Tensor   # (d_model, d_model)
    norm_ff2_w: torch.Tensor
    norm_ff2_b: torch.Tensor
    ffn2_w1: torch.Tensor
    ffn2_w2: torch.Tensor
    norm_final_w: torch.Tensor
    norm_final_b: torch.Tensor


@dataclasses.dataclass
class DecoderParams:
    embedding: torch.Tensor  # (vocab_size, decoder_dim)
    w_ih: torch.Tensor       # (2, 4*hidden, input)
    w_hh: torch.Tensor       # (2, 4*hidden, hidden)
    b_ih: torch.Tensor       # (2, 4*hidden)
    b_hh: torch.Tensor       # (2, 4*hidden)


@dataclasses.dataclass
class JointParams:
    enc_w: torch.Tensor  # (joint_dim, d_model)
    enc_b: torch.Tensor
    dec_w: torch.Tensor  # (joint_dim, decoder_dim)
    dec_b: torch.Tensor
    out_w: torch.Tensor  # (vocab_size, joint_dim)
    out_b: torch.Tensor


@dataclasses.dataclass
class PromptParams:
    """Language-ID fusion MLP (multilingual checkpoints)."""

    fc1_w: torch.Tensor  # (2*d_model, d_model + num_prompts)
    fc1_b: torch.Tensor
    fc2_w: torch.Tensor  # (d_model, 2*d_model)
    fc2_b: torch.Tensor


@dataclasses.dataclass
class PreprocParams:
    filterbank: torch.Tensor  # (n_mels, n_fft//2+1), f32
    window: torch.Tensor      # (400,), f32


@dataclasses.dataclass
class ModelParams:
    subsampling: SubsamplingParams
    layers: ConformerLayerParams  # stacked: every field has leading [L]
    decoder: DecoderParams
    joint: JointParams
    preproc: PreprocParams
    pos_emb: torch.Tensor         # (2*max_pos_len-1, d_model)
    prompt: PromptParams | None = None


def layer_slice(layers: ConformerLayerParams, i: int) -> ConformerLayerParams:
    """Views of layer i of the stacked layer parameters (no copies; a
    quantized field gives the views of its codes and scales)."""
    return ConformerLayerParams(
        **{f.name: getattr(layers, f.name)[i]
           for f in dataclasses.fields(layers)})


def params_to(params: ModelParams, device=None, dtype=None) -> ModelParams:
    """Move every tensor to `device`; cast floating tensors other than the
    f32 frontend tables (filterbank, window) to `dtype`. Quantized weights
    only move: their codes stay integer and their scales f32."""

    def conv(obj):
        if obj is None:
            return None
        if is_quantized(obj):
            return obj.to(device)
        if isinstance(obj, torch.Tensor):
            return obj.to(device=device, dtype=dtype)
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(obj, PreprocParams):
                kw[f.name] = v.to(device=device)
            else:
                kw[f.name] = conv(v)
        return dataclasses.replace(obj, **kw)

    return conv(params)


def params_from_numpy(tree, device="cpu", dtype=torch.float32) -> ModelParams:
    """Bridge from the JAX package: `tree` is its ModelParams (or any object
    with the same field names) whose leaves convert with np.asarray. Every
    leaf is copied, so in-place updates never reach the source. A quantized
    leaf (JAX QuantizedTensor / QuantizedTensor4) keeps its int8 / uint8
    codes exactly and its scales in f32."""

    def leaf(x, dt):
        if hasattr(x, "w_i8"):
            return QuantizedTensor(exact(x.w_i8), exact(x.scales))
        if hasattr(x, "w_packed"):
            return QuantizedTensor4(exact(x.w_packed), exact(x.scales))
        return torch.tensor(np.asarray(x, dtype=np.float32), dtype=dt,
                            device=device)

    def exact(x):
        return torch.tensor(np.asarray(x), device=device)

    def group(cls, src, dt=dtype):
        return cls(**{f.name: leaf(getattr(src, f.name), dt)
                      for f in dataclasses.fields(cls)})

    prompt = getattr(tree, "prompt", None)
    return ModelParams(
        subsampling=group(SubsamplingParams, tree.subsampling),
        layers=group(ConformerLayerParams, tree.layers),
        decoder=group(DecoderParams, tree.decoder),
        joint=group(JointParams, tree.joint),
        preproc=group(PreprocParams, tree.preproc, torch.float32),
        pos_emb=leaf(tree.pos_emb, dtype),
        prompt=None if prompt is None else group(PromptParams, prompt),
    )


def compute_pos_emb(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoidal table in NeMo's descending order: row p holds position
    (max_len-1) - p, so row 0 is the most positive relative distance."""
    total = 2 * max_len - 1
    p = (max_len - 1) - np.arange(total, dtype=np.float32)
    i = np.arange(0, d_model, 2, dtype=np.float32)
    div = np.exp(-i * np.log(10000.0) / d_model)
    ang = p[:, None] * div[None, :]
    out = np.zeros((total, d_model), dtype=np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


# GGUF tensor-name mapping (same as nemotron_tpu/params.py)
_SUB_MAP = {
    "conv0_w": "encoder.pre_encode.conv.0.weight",
    "conv0_b": "encoder.pre_encode.conv.0.bias",
    "conv2_w": "encoder.pre_encode.conv.2.weight",
    "conv2_b": "encoder.pre_encode.conv.2.bias",
    "conv3_w": "encoder.pre_encode.conv.3.weight",
    "conv3_b": "encoder.pre_encode.conv.3.bias",
    "conv5_w": "encoder.pre_encode.conv.5.weight",
    "conv5_b": "encoder.pre_encode.conv.5.bias",
    "conv6_w": "encoder.pre_encode.conv.6.weight",
    "conv6_b": "encoder.pre_encode.conv.6.bias",
    "out_w": "encoder.pre_encode.out.weight",
    "out_b": "encoder.pre_encode.out.bias",
}

_LAYER_MAP = {
    "norm_ff1_w": "norm_feed_forward1.weight",
    "norm_ff1_b": "norm_feed_forward1.bias",
    "ffn1_w1": "feed_forward1.linear1.weight",
    "ffn1_w2": "feed_forward1.linear2.weight",
    "norm_attn_w": "norm_self_att.weight",
    "norm_attn_b": "norm_self_att.bias",
    "attn_q_w": "self_attn.linear_q.weight",
    "attn_k_w": "self_attn.linear_k.weight",
    "attn_v_w": "self_attn.linear_v.weight",
    "attn_pos_w": "self_attn.linear_pos.weight",
    "attn_out_w": "self_attn.linear_out.weight",
    "pos_bias_u": "self_attn.pos_bias_u",
    "pos_bias_v": "self_attn.pos_bias_v",
    "norm_conv_w": "norm_conv.weight",
    "norm_conv_b": "norm_conv.bias",
    "conv_pw1_w": "conv.pointwise_conv1.weight",
    "conv_dw_w": "conv.depthwise_conv.weight",
    "conv_ln_w": "conv.batch_norm.weight",
    "conv_ln_b": "conv.batch_norm.bias",
    "conv_pw2_w": "conv.pointwise_conv2.weight",
    "norm_ff2_w": "norm_feed_forward2.weight",
    "norm_ff2_b": "norm_feed_forward2.bias",
    "ffn2_w1": "feed_forward2.linear1.weight",
    "ffn2_w2": "feed_forward2.linear2.weight",
    "norm_final_w": "norm_out.weight",
    "norm_final_b": "norm_out.bias",
}

_JOINT_MAP = {
    "enc_w": "joint.enc.weight",
    "enc_b": "joint.enc.bias",
    "dec_w": "joint.pred.weight",
    "dec_b": "joint.pred.bias",
    "out_w": "joint.joint_net.2.weight",
    "out_b": "joint.joint_net.2.bias",
}


def hparams_from_kv(kv: dict) -> Hparams:
    def get(key, default):
        return int(kv.get(f"nemo.{key}", default))

    d_model = get("d_model", 1024)
    n_heads = get("n_heads", 8)
    return Hparams(
        n_mels=get("n_mels", 128),
        d_model=d_model,
        n_heads=n_heads,
        d_head=get("d_head", d_model // n_heads),
        d_ff=get("d_ff", 4096),
        n_layers=get("n_layers", 24),
        kernel_size=get("kernel_size", 9),
        vocab_size=get("vocab_size", 1025),
        decoder_dim=get("decoder_dim", 640),
        joint_dim=get("joint_dim", 640),
        subsampling_factor=get("subsampling_factor", 8),
        subsampling_channels=get("subsampling_channels", 256),
        att_left_context=get("att_left_context", 70),
        num_prompts=get("num_prompts", 0),
    )


def _normalize_conv_weights(name: str, arr: np.ndarray) -> np.ndarray:
    """Accept both the reshaped-2D GGUF layout and raw PyTorch 3D conv layouts."""
    if name.endswith("conv.depthwise_conv.weight"):
        if arr.ndim == 3:  # (ch, 1, k) -> (k, ch)
            arr = arr[:, 0, :].T
        return np.ascontiguousarray(arr)
    if name.endswith(("pointwise_conv1.weight", "pointwise_conv2.weight")):
        if arr.ndim == 3:  # (out, in, 1) -> (out, in)
            arr = arr[:, :, 0]
        return np.ascontiguousarray(arr)
    return arr


def norm_featurizer_fb(arr) -> np.ndarray:
    """[1, n_mels, n_bins] (NeMo registration) or [n_mels, n_bins] -> 2D f32."""
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 3:
        arr = arr.reshape(arr.shape[-2], arr.shape[-1])
    return arr


def load_model(path: str, dtype=torch.float32, device="cpu",
               keep_quantized: bool = False
               ) -> tuple[Hparams, ModelParams, dict]:
    """Load a GGUF checkpoint into stacked tensors.

    Returns (hparams, params, meta) with meta carrying vocab / prompt dict.
    F16, Q8_0 and Q4_0 tensors are dequantized at load. With
    keep_quantized, a layer field whose tensors are all Q8_0 (or all Q4_0)
    stays quantized: a QuantizedTensor (QuantizedTensor4) read from the raw
    payload, dequantized inside kernel B4 (B5) on the card.
    """
    g = read_gguf(path)
    hp = hparams_from_kv(g.kv)
    raw = g.load_all()

    dw = raw.get("encoder.layers.0.conv.depthwise_conv.weight")
    if dw is not None:
        k = dw.shape[0] if dw.ndim == 2 else dw.shape[-1]
        hp = dataclasses.replace(hp, kernel_size=int(k))
    c0 = raw.get("encoder.pre_encode.conv.0.weight")
    if c0 is not None:
        hp = dataclasses.replace(hp, subsampling_channels=int(c0.shape[0]))

    def T(arr, dt=dtype):
        return torch.tensor(np.asarray(arr, dtype=np.float32), dtype=dt,
                            device=device)

    def J(name):
        return T(_normalize_conv_weights(name, raw[name]))

    def layer_field(suffix):
        names = [f"encoder.layers.{i}.{suffix}" for i in range(hp.n_layers)]
        types = {g.tensors[n].ggml_type for n in names}
        for code, read, cls in ((GGML_Q8_0, from_gguf_q8, QuantizedTensor),
                                (GGML_Q4_0, from_gguf_q4, QuantizedTensor4)):
            if keep_quantized and types == {code}:
                qts = [read(g.raw_tensor(n), *g.tensors[n].shape)
                       for n in names]
                return cls(*(torch.stack([getattr(q, f.name) for q in qts]
                                         ).to(device)
                             for f in dataclasses.fields(cls)))
        return T(np.stack([_normalize_conv_weights(n, raw[n])
                           for n in names]))

    sub = SubsamplingParams(**{f: J(n) for f, n in _SUB_MAP.items()})
    layers = ConformerLayerParams(**{
        field: layer_field(suffix) for field, suffix in _LAYER_MAP.items()})
    rnn = "decoder.prediction.dec_rnn.lstm"
    dec = DecoderParams(
        embedding=J("decoder.prediction.embed.weight"),
        w_ih=torch.stack([J(f"{rnn}.weight_ih_l{i}") for i in range(2)]),
        w_hh=torch.stack([J(f"{rnn}.weight_hh_l{i}") for i in range(2)]),
        b_ih=torch.stack([J(f"{rnn}.bias_ih_l{i}") for i in range(2)]),
        b_hh=torch.stack([J(f"{rnn}.bias_hh_l{i}") for i in range(2)]),
    )
    joint = JointParams(**{f: J(n) for f, n in _JOINT_MAP.items()})
    prompt = None
    if hp.num_prompts > 0:
        prompt = PromptParams(
            fc1_w=J("prompt_kernel.0.weight"), fc1_b=J("prompt_kernel.0.bias"),
            fc2_w=J("prompt_kernel.2.weight"), fc2_b=J("prompt_kernel.2.bias"),
        )
    preproc = PreprocParams(
        filterbank=T(norm_featurizer_fb(raw["preprocessor.featurizer.fb"]),
                     torch.float32),
        window=T(np.asarray(raw["preprocessor.featurizer.window"],
                            np.float32).reshape(-1), torch.float32),
    )
    params = ModelParams(
        subsampling=sub, layers=layers, decoder=dec, joint=joint,
        preproc=preproc, pos_emb=T(compute_pos_emb(hp.max_pos_len, hp.d_model)),
        prompt=prompt,
    )

    vocab = g.kv.get("tokenizer.vocab_list")
    if vocab is None and "tokenizer.vocab" in g.kv:
        blob = g.kv["tokenizer.vocab"]
        if isinstance(blob, str):
            blob = blob.encode("utf-8", errors="replace")
        vocab = [
            blob[i * 8:i * 8 + 8].split(b"\x00")[0].decode("utf-8",
                                                           errors="replace")
            for i in range(hp.vocab_size - 1)
        ]
    prompt_dict = {}
    if "nemo.prompt_langs" in g.kv and "nemo.prompt_ids" in g.kv:
        prompt_dict = dict(zip(g.kv["nemo.prompt_langs"], g.kv["nemo.prompt_ids"]))
    meta = {"vocab": vocab or [], "prompt_dict": prompt_dict, "kv": g.kv}
    return hp, params, meta


# The reference's default quantization set: the encoder layers' 2-D
# matrices; depthwise conv, norms, biases and position biases stay dense.
QUANT_LAYER_FIELDS = (
    "ffn1_w1", "ffn1_w2", "ffn2_w1", "ffn2_w2",
    "attn_q_w", "attn_k_w", "attn_v_w", "attn_pos_w", "attn_out_w",
    "conv_pw1_w", "conv_pw2_w",
)


def quantize_encoder_layers(params: ModelParams, bits: int = 8
                            ) -> ModelParams:
    """Weight-only quantization of the stacked encoder-layer matrices to
    Q8_0 (bits=8) or Q4_0 (bits=4), as nemotron_tpu/params.py does: a field
    whose input width is not a multiple of 32 (Q8) or 64 (Q4) stays dense.
    The quantized leaves land on the device of the dense ones."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    lay = params.layers
    upd = {}
    for name in QUANT_LAYER_FIELDS:
        w = getattr(lay, name)
        if w.dim() != 3 or w.shape[-1] % (32 if bits == 8 else 64):
            continue
        v = w.detach().float().cpu().numpy()  # [L, out, in]
        upd[name] = (quantize_q8(v) if bits == 8 else quantize_q4(v)
                     ).to(w.device)
    return dataclasses.replace(params, layers=dataclasses.replace(lay, **upd))


def random_params(hp: Hparams, seed: int = 0, dtype=torch.float32,
                  device="cpu") -> ModelParams:
    """Random weights drawing the same numpy stream, in the same order, as
    nemotron_tpu/params.py:random_params (identical values in f32)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=None):
        if scale is None:
            scale = 1.0 / np.sqrt(shape[-1]) if len(shape) > 1 else 0.02
        arr = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.tensor(np.asarray(arr, np.float32), dtype=dtype,
                            device=device)

    def ones(*s):
        return torch.ones(s, dtype=dtype, device=device)

    def zeros(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    C = hp.subsampling_channels
    D, H, Dh, F, L = hp.d_model, hp.n_heads, hp.d_head, hp.d_ff, hp.n_layers
    V, Dd, K = hp.vocab_size, hp.decoder_dim, hp.kernel_size

    sub = SubsamplingParams(
        conv0_w=r(C, 1, 3, 3, scale=0.2), conv0_b=r(C),
        conv2_w=r(C, 1, 3, 3, scale=0.2), conv2_b=r(C),
        conv3_w=r(C, C, 1, 1), conv3_b=r(C),
        conv5_w=r(C, 1, 3, 3, scale=0.2), conv5_b=r(C),
        conv6_w=r(C, C, 1, 1), conv6_b=r(C),
        out_w=r(D, hp.subsampling_flat_dim), out_b=r(D),
    )
    layers = ConformerLayerParams(
        norm_ff1_w=ones(L, D), norm_ff1_b=zeros(L, D),
        ffn1_w1=r(L, F, D), ffn1_w2=r(L, D, F),
        norm_attn_w=ones(L, D), norm_attn_b=zeros(L, D),
        attn_q_w=r(L, D, D), attn_k_w=r(L, D, D), attn_v_w=r(L, D, D),
        attn_pos_w=r(L, D, D), attn_out_w=r(L, D, D),
        pos_bias_u=r(L, H, Dh, scale=0.1), pos_bias_v=r(L, H, Dh, scale=0.1),
        norm_conv_w=ones(L, D), norm_conv_b=zeros(L, D),
        conv_pw1_w=r(L, 2 * D, D), conv_dw_w=r(L, K, D, scale=0.3),
        conv_ln_w=ones(L, D), conv_ln_b=zeros(L, D),
        conv_pw2_w=r(L, D, D),
        norm_ff2_w=ones(L, D), norm_ff2_b=zeros(L, D),
        ffn2_w1=r(L, F, D), ffn2_w2=r(L, D, F),
        norm_final_w=ones(L, D), norm_final_b=zeros(L, D),
    )
    dec = DecoderParams(
        embedding=r(V, Dd, scale=0.1),
        w_ih=r(2, 4 * Dd, Dd),
        w_hh=r(2, 4 * Dd, Dd),
        b_ih=zeros(2, 4 * Dd),
        b_hh=zeros(2, 4 * Dd),
    )
    joint = JointParams(
        enc_w=r(hp.joint_dim, D), enc_b=zeros(hp.joint_dim),
        dec_w=r(hp.joint_dim, Dd), dec_b=zeros(hp.joint_dim),
        out_w=r(V, hp.joint_dim), out_b=zeros(V),
    )
    prompt = None
    if hp.num_prompts > 0:
        prompt = PromptParams(
            fc1_w=r(2 * D, D + hp.num_prompts), fc1_b=zeros(2 * D),
            fc2_w=r(D, 2 * D), fc2_b=zeros(D),
        )
    fb = rng.uniform(0.0, 1.0, (hp.n_mels, 257)).astype(np.float32)
    preproc = PreprocParams(
        filterbank=torch.tensor(fb, device=device),
        window=torch.tensor(np.hanning(400).astype(np.float32), device=device),
    )
    return ModelParams(
        subsampling=sub, layers=layers, decoder=dec, joint=joint,
        preproc=preproc,
        pos_emb=torch.tensor(compute_pos_emb(hp.max_pos_len, hp.d_model),
                             dtype=dtype, device=device),
        prompt=prompt,
    )
