"""Diarization model parameters: MarbleNet VAD + TitaNet-L speaker encoder
(port of nemotron_tpu/diarize/params.py).

Loads the combined diarize.gguf (vad.* / spk.* namespaces, the converter's
tensor names) with the port's GGUF reader. BatchNorms are folded into
per-channel (scale, bias) at load: encoder BNs with eps 1e-3 (NeMo Jasper),
decoder BNs with eps 1e-5. The trees are plain dataclasses of f32 tensors
on an explicit device, with the JAX package's field names and layouts
(depthwise [k, C], pointwise and linear (out, in)), so the two compare leaf
by leaf; `diarize_params_from_numpy` builds one from the JAX package's
DiarizeModelParams."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..gguf.reader import read_gguf
from ..graphs import GraphCache
# the ASR loader's filterbank normalisation: a layout quirk fixed in one
# loader must not ship broken in the other
from ..params import device_of, norm_featurizer_fb as _norm_fb

ENC_BN_EPS = 1e-3
DEC_BN_EPS = 1e-5

# (kernel, dilation, repeat, in_ch, out_ch, residual, separable, has_se)
VAD_TOPOLOGY = (
    (11, 1, 1, 80, 128, False, True, False),
    (13, 1, 2, 128, 64, True, True, False),
    (15, 1, 2, 64, 64, True, True, False),
    (17, 1, 2, 64, 64, True, True, False),
    (29, 2, 1, 64, 128, False, True, False),
    (1, 1, 1, 128, 128, False, False, False),
)
SPK_TOPOLOGY = (
    (3, 1, 1, 80, 1024, False, True, True),
    (7, 1, 3, 1024, 1024, True, True, True),
    (11, 1, 3, 1024, 1024, True, True, True),
    (15, 1, 3, 1024, 1024, True, True, True),
    (1, 1, 1, 1024, 3072, False, True, True),
)
SE_REDUCTION = 8


@dataclasses.dataclass
class SubConvParams:
    dw: torch.Tensor | None  # [k, C_in] kernel-major, None if not separable
    pw: torch.Tensor         # [C_out, C_in]
    bn_scale: torch.Tensor   # [C_out]
    bn_bias: torch.Tensor    # [C_out]


@dataclasses.dataclass
class JasperBlockParams:
    subs: tuple              # tuple[SubConvParams]
    res: SubConvParams | None
    se_fc1: torch.Tensor | None  # [C/r, C]
    se_fc2: torch.Tensor | None  # [C, C/r]


@dataclasses.dataclass
class VadParams:
    blocks: tuple            # tuple[JasperBlockParams]
    dec_w: torch.Tensor      # [n_classes, C]
    dec_b: torch.Tensor      # [n_classes]
    fb: torch.Tensor         # [80, 257]
    window: torch.Tensor     # [400]


@dataclasses.dataclass
class SpkDecoderParams:
    attn1_w: torch.Tensor       # [attn_C, 3C]
    attn1_b: torch.Tensor       # [attn_C]
    attn_bn_scale: torch.Tensor
    attn_bn_bias: torch.Tensor
    attn2_w: torch.Tensor       # [C, attn_C]
    attn2_b: torch.Tensor       # [C]
    emb_bn_scale: torch.Tensor  # [2C]
    emb_bn_bias: torch.Tensor
    emb_w: torch.Tensor         # [emb_dim, 2C]
    emb_b: torch.Tensor         # [emb_dim]


@dataclasses.dataclass
class SpkParams:
    blocks: tuple
    dec: SpkDecoderParams
    fb: torch.Tensor
    window: torch.Tensor


@dataclasses.dataclass
class DiarizeModelParams:
    vad: VadParams
    spk: SpkParams
    kv: dict
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        # the nets' compiled calls, one CUDA graph per (net, bucket),
        # shared by every pipeline of this model (diarize/pipeline.py);
        # not a field: the fields are the JAX package's tree
        self.graphs = GraphCache()


def _fold(raw, prefix, eps):
    gamma = raw[f"{prefix}.weight"]
    beta = raw[f"{prefix}.bias"]
    mean = raw[f"{prefix}.running_mean"]
    var = raw[f"{prefix}.running_var"]
    scale = gamma / np.sqrt(var + eps)
    return scale.astype(np.float32), (beta - mean * scale).astype(np.float32)


def _norm_dw(arr):
    """Depthwise conv weight to [k, C] whatever the on-disk layout."""
    if arr.ndim == 3:  # torch (C, 1, k)
        return np.ascontiguousarray(arr[:, 0, :].T)
    return arr  # already (k, C) from the converter


def _norm_pw(arr):
    if arr.ndim == 3:  # torch (out, in, 1)
        return np.ascontiguousarray(arr[:, :, 0])
    return arr


def _loader(device):
    def J(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)
    return J


def _load_subconv(J, raw, prefix, dw_idx, pw_idx, bn_idx, separable, eps):
    dw = None
    if separable:
        dw = J(_norm_dw(raw[f"{prefix}.mconv.{dw_idx}.conv.weight"]))
    pw = J(_norm_pw(raw[f"{prefix}.mconv.{pw_idx}.conv.weight"]))
    scale, bias = _fold(raw, f"{prefix}.mconv.{bn_idx}", eps)
    return SubConvParams(dw=dw, pw=pw, bn_scale=J(scale), bn_bias=J(bias))


def _load_residual(J, raw, prefix, eps):
    pw = J(_norm_pw(raw[f"{prefix}.res.0.0.conv.weight"]))
    scale, bias = _fold(raw, f"{prefix}.res.0.1", eps)
    return SubConvParams(dw=None, pw=pw, bn_scale=J(scale), bn_bias=J(bias))


def _load_blocks(J, raw, ns, topology):
    """ns = 'vad' or 'spk'. mconv layout: 5 modules per repeat (dw, pw, bn,
    relu, dropout); SE (if any) is the final mconv entry at 5*(R-1)+3."""
    blocks = []
    for b, (k, dil, repeat, cin, cout, residual, separable, has_se) in \
            enumerate(topology):
        prefix = f"{ns}.encoder.encoder.{b}"
        subs = []
        for s in range(repeat):
            base = 5 * s
            if separable:
                subs.append(_load_subconv(J, raw, prefix, base, base + 1,
                                          base + 2, True, ENC_BN_EPS))
            else:
                subs.append(_load_subconv(J, raw, prefix, -1, 0, 1, False,
                                          ENC_BN_EPS))
        res = _load_residual(J, raw, prefix, ENC_BN_EPS) if residual else None
        se_fc1 = se_fc2 = None
        if has_se:
            se_idx = 5 * (repeat - 1) + 3
            se_fc1 = J(raw[f"{prefix}.mconv.{se_idx}.fc.0.weight"])
            se_fc2 = J(raw[f"{prefix}.mconv.{se_idx}.fc.2.weight"])
        blocks.append(JasperBlockParams(subs=tuple(subs), res=res,
                                        se_fc1=se_fc1, se_fc2=se_fc2))
    return tuple(blocks)


def load_diarize_model(path: str, device="cuda") -> DiarizeModelParams:
    """The diarize GGUF at `path` on `device` (the card unless the caller
    asks for the CPU; without a card, "cuda" raises)."""
    device = device_of(device)
    g = read_gguf(path)
    raw = g.load_all()
    J = _loader(device)

    vad = VadParams(
        blocks=_load_blocks(J, raw, "vad", VAD_TOPOLOGY),
        dec_w=J(raw["vad.decoder.decoder_layers.0.weight"]),
        dec_b=J(raw["vad.decoder.decoder_layers.0.bias"]),
        fb=J(_norm_fb(raw["vad.preprocessor.featurizer.fb"])),
        window=J(np.asarray(raw["vad.preprocessor.featurizer.window"]
                            ).reshape(-1)),
    )

    dp = "spk.decoder"
    a_scale, a_bias = _fold(raw, f"{dp}._pooling.attention_layer.0.bn",
                            DEC_BN_EPS)
    e_scale, e_bias = _fold(raw, f"{dp}.emb_layers.0.0", DEC_BN_EPS)
    dec = SpkDecoderParams(
        attn1_w=J(_norm_pw(
            raw[f"{dp}._pooling.attention_layer.0.conv_layer.weight"])),
        attn1_b=J(raw[f"{dp}._pooling.attention_layer.0.conv_layer.bias"]),
        attn_bn_scale=J(a_scale),
        attn_bn_bias=J(a_bias),
        attn2_w=J(_norm_pw(raw[f"{dp}._pooling.attention_layer.2.weight"])),
        attn2_b=J(raw[f"{dp}._pooling.attention_layer.2.bias"]),
        emb_bn_scale=J(e_scale),
        emb_bn_bias=J(e_bias),
        emb_w=J(_norm_pw(raw[f"{dp}.emb_layers.0.1.weight"])),
        emb_b=J(raw[f"{dp}.emb_layers.0.1.bias"]),
    )
    spk = SpkParams(
        blocks=_load_blocks(J, raw, "spk", SPK_TOPOLOGY),
        dec=dec,
        fb=J(_norm_fb(raw["spk.preprocessor.featurizer.fb"])),
        window=J(np.asarray(raw["spk.preprocessor.featurizer.window"]
                            ).reshape(-1)),
    )
    return DiarizeModelParams(vad=vad, spk=spk, kv=g.kv, device=device)


def diarize_params_from_numpy(tree, device="cuda") -> DiarizeModelParams:
    """Bridge from the JAX package: `tree` is its DiarizeModelParams (or any
    object with the same field names) whose leaves convert with np.asarray;
    every leaf is copied as f32 onto `device`."""
    device = device_of(device)
    J = _loader(device)

    def conv(cls, src):
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(src, f.name)
            if f.name == "subs":
                kw[f.name] = tuple(conv(SubConvParams, s) for s in v)
            elif f.name == "blocks":
                kw[f.name] = tuple(conv(JasperBlockParams, b) for b in v)
            elif f.name == "res":
                kw[f.name] = None if v is None else conv(SubConvParams, v)
            elif f.name == "dec":
                kw[f.name] = conv(SpkDecoderParams, v)
            else:
                kw[f.name] = None if v is None else J(v)
        return cls(**kw)

    return DiarizeModelParams(vad=conv(VadParams, tree.vad),
                              spk=conv(SpkParams, tree.spk),
                              kv=dict(tree.kv), device=device)
