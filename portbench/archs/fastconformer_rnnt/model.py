"""The model a cell of this architecture runs: weights made on the device
from the seed, handed as the same tensors to the program
(nemotron_tpu_torch's ASRModel) and to the reference (a plain dict,
reference.py).

A configuration file (portbench/configs/<name>.json) fixes the widths
("model", the port's Hparams fields), the activation type and which encoder
matrices are Q8_0 (codes and scales, as a GGUF file holds them: one fp16
scale per block of 32 inputs); the blank's bias is set per run
(calibrate.py). The weights are Gaussian, scaled by 1/sqrt(fan-in) and by
the constants below, the same for every configuration: the matrices that
end a residual branch (RESIDUAL_OUT_SCALE: each FFN's second matrix,
attention's output, the conv module's second pointwise) so that the
residual stream keeps each frame's own features through 24 layers, and the
prediction net's embedding and the joint's projection of it
(EMBEDDING_SCALE, PRED_PROJ_SCALE) so that an emitted token moves the joint
as much as a frame does, and the joint's blank row (BLANK_ROW_SCALE) so
that the blank's logit varies from decision to decision as much as the best
token's does (with a row like the others', every decision is the same
comparison of a constant bias against the largest of 1,024 logits of one
spread, and a stream emits at every frame or at none), and the first
subsampling convolution's kernels sum to zero, as trained edge-like filters
do, so that the log-mel's level does not make every frame alike. Layer
norms are ones and zeros; the filterbank is the Slaney-normalised mel
filterbank and the window a 400-sample Hann window, as NeMo's preprocessor
has them; the positional table is NeMo's sinusoid table.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

QBLOCK = 32
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# fields of the stacked conformer layers, with their shape and scale rule
_LAYER_RANDOM = {
    "ffn1_w1": ("F", "D"), "ffn1_w2": ("D", "F"),
    "ffn2_w1": ("F", "D"), "ffn2_w2": ("D", "F"),
    "attn_q_w": ("D", "D"), "attn_k_w": ("D", "D"), "attn_v_w": ("D", "D"),
    "attn_pos_w": ("D", "D"), "attn_out_w": ("D", "D"),
    "conv_pw1_w": ("2D", "D"), "conv_pw2_w": ("D", "D"),
}
_RESIDUAL_OUT = ("ffn1_w2", "ffn2_w2", "attn_out_w", "conv_pw2_w")
RESIDUAL_OUT_SCALE = 0.144  # about 1/sqrt(2 x 24 residual branches)
EMBEDDING_SCALE = 1.0
PRED_PROJ_SCALE = 2.0
BLANK_ROW_SCALE = 4.0
_LAYER_NORMS = ("norm_ff1", "norm_attn", "norm_conv", "conv_ln", "norm_ff2",
                "norm_final")


def slaney_filterbank(n_mels: int, sr: int = 16000,
                      n_fft: int = 512) -> np.ndarray:
    """[n_mels, n_fft // 2 + 1] triangles on the Slaney mel scale, area
    normalised (librosa.filters.mel(htk=False, norm="slaney"))."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27)
        return np.where(f >= 1000.0, log, lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        lin = m * (200.0 / 3)
        log = 1000.0 * np.exp((np.log(6.4) / 27) * (m - 15.0))
        return np.where(m >= 15.0, log, lin)

    fft_f = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0),
                                  n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def sinusoid_table(max_len: int, d_model: int) -> torch.Tensor:
    """[2 max_len - 1, d_model] float32, row p holding relative position
    (max_len - 1) - p (NeMo's RelPositionalEncoding order)."""
    p = torch.arange(max_len - 1, -max_len, -1, dtype=torch.float64)
    div = torch.exp(-torch.arange(0, d_model, 2, dtype=torch.float64)
                    * (math.log(10000.0) / d_model))
    ang = p[:, None] * div[None, :]
    out = torch.empty(2 * max_len - 1, d_model, dtype=torch.float64)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out.to(torch.float32)


def q8_0(w: torch.Tensor):
    """[..., out, in] -> (codes int8, scales float32 [..., out, in / 32]):
    GGUF's Q8_0, the scale amax / 127 stored as fp16, codes rounded
    against the stored scale."""
    blocks = w.float().unflatten(-1, (-1, QBLOCK))
    d = (blocks.abs().amax(-1) / 127.0).half().float()
    d = torch.where(d > 0, d, torch.ones_like(d))
    codes = torch.round(blocks / d[..., None]).clamp_(-127, 127)
    return codes.to(torch.int8).flatten(-2), d


def make_weights(conf: dict, seed: int, device) -> dict:
    """The reference's weight dict, made on `device` from `seed` in the
    served types: dense tensors in the activation type, Q8_0 fields as
    {"codes", "scales"}, the frontend tables and the positional table in
    float32."""
    hp = conf["model"]
    act = DTYPES[conf["activations"]]
    quant = set(conf.get("q8_0_fields", ()))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    D, F, L = hp["d_model"], hp["d_ff"], hp["n_layers"]
    C, H = hp["subsampling_channels"], hp["n_heads"]
    dims = {"D": D, "F": F, "2D": 2 * D}

    def randn(*shape, scale, dtype=act):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return t.mul_(scale)

    w = {}
    flat = ((hp["n_mels"] // 2 + 1) // 2 + 1) // 2 + 1
    w["sub.conv0_w"] = randn(C, 1, 3, 3, scale=1 / 3)
    w["sub.conv0_w"].sub_(w["sub.conv0_w"].mean(dim=(2, 3), keepdim=True))
    w["sub.conv2_w"] = randn(C, 1, 3, 3, scale=1 / 3)
    w["sub.conv3_w"] = randn(C, C, 1, 1, scale=C ** -0.5)
    w["sub.conv5_w"] = randn(C, 1, 3, 3, scale=1 / 3)
    w["sub.conv6_w"] = randn(C, C, 1, 1, scale=C ** -0.5)
    for b in ("conv0_b", "conv2_b", "conv3_b", "conv5_b", "conv6_b"):
        w["sub." + b] = randn(C, scale=0.02)
    w["sub.out_w"] = randn(D, flat * C, scale=(flat * C) ** -0.5)
    w["sub.out_b"] = randn(D, scale=0.02)
    for name, (o, i) in _LAYER_RANDOM.items():
        scale = dims[i] ** -0.5
        if name in _RESIDUAL_OUT:
            scale *= RESIDUAL_OUT_SCALE
        if name in quant:
            codes, scales = q8_0(randn(L, dims[o], dims[i], scale=scale,
                                       dtype=torch.float32))
            w["layers." + name] = {"codes": codes, "scales": scales}
        else:
            w["layers." + name] = randn(L, dims[o], dims[i], scale=scale)
    w["layers.pos_bias_u"] = randn(L, H, D // H, scale=0.1)
    w["layers.pos_bias_v"] = randn(L, H, D // H, scale=0.1)
    w["layers.conv_dw_w"] = randn(L, hp["kernel_size"], D,
                                  scale=hp["kernel_size"] ** -0.5)
    for n in _LAYER_NORMS:
        w[f"layers.{n}_w"] = torch.ones(L, D, dtype=act, device=device)
        w[f"layers.{n}_b"] = torch.zeros(L, D, dtype=act, device=device)
    V, Dd, J = hp["vocab_size"], hp["decoder_dim"], hp["joint_dim"]
    w["dec.embedding"] = randn(V, Dd, scale=EMBEDDING_SCALE)
    w["dec.w_ih"] = randn(2, 4 * Dd, Dd, scale=Dd ** -0.5)
    w["dec.w_hh"] = randn(2, 4 * Dd, Dd, scale=Dd ** -0.5)
    w["dec.b_ih"] = torch.zeros(2, 4 * Dd, dtype=act, device=device)
    w["dec.b_hh"] = torch.zeros(2, 4 * Dd, dtype=act, device=device)
    w["joint.enc_w"] = randn(J, D, scale=D ** -0.5)
    w["joint.enc_b"] = torch.zeros(J, dtype=act, device=device)
    w["joint.dec_w"] = randn(J, Dd, scale=PRED_PROJ_SCALE * Dd ** -0.5)
    w["joint.dec_b"] = torch.zeros(J, dtype=act, device=device)
    w["joint.out_w"] = randn(V, J, scale=J ** -0.5)
    w["joint.out_w"][V - 1].mul_(BLANK_ROW_SCALE)
    # the blank's bias is set per run (calibrate.py, set_blank_bias)
    w["joint.out_b"] = torch.zeros(V, dtype=act, device=device)
    w["pre.filterbank"] = torch.tensor(slaney_filterbank(hp["n_mels"]),
                                       device=device)
    w["pre.window"] = torch.hann_window(400, periodic=False,
                                        dtype=torch.float32, device=device)
    w["pos_table"] = sinusoid_table(hp["max_pos_len"], D).to(device)
    return w


def set_blank_bias(w: dict, bias: float) -> None:
    """The joint's bias of the blank (its last token), shared by the
    program and the reference."""
    w["joint.out_b"][-1] = bias


def has_q4_0_control(conf: dict) -> bool:
    """Whether program_model(q4_0=True) has matrices to requantize: a
    configuration with Q8_0 matrices."""
    return bool(conf.get("q8_0_fields"))


def vocabulary(vocab_size: int) -> list[str]:
    """Every token a word of its own (▁w<id>), so served text reads back
    to token ids, and with timestamps to their frames."""
    return ["▁w%d" % i for i in range(vocab_size - 1)]


def program_model(conf: dict, w: dict, device, q4_0: bool = False):
    """nemotron_tpu_torch's ASRModel on the same tensors. q4_0: the
    control of a Q8_0 configuration, the program's own Q4_0 path (B5): each
    Q8_0 matrix, as its codes and scales give it, quantized again to Q4_0
    by the program."""
    from nemotron_tpu_torch.api import ASRModel
    from nemotron_tpu_torch.config import Hparams
    from nemotron_tpu_torch.ops.quant import QuantizedTensor, quantize_q4
    from nemotron_tpu_torch import params as P

    hp = Hparams(**conf["model"])
    act = DTYPES[conf["activations"]]

    def group(cls, prefix):
        return cls(**{f.name: w[prefix + f.name]
                      for f in dataclasses.fields(cls)})

    def layer_field(name):
        v = w["layers." + name]
        if not isinstance(v, dict):
            return v
        if q4_0:
            dense = v["codes"].float() * v["scales"].repeat_interleave(
                QBLOCK, dim=-1)
            return quantize_q4(dense.cpu().numpy()).to(device)
        return QuantizedTensor(v["codes"], v["scales"])

    layers = P.ConformerLayerParams(**{
        f.name: layer_field(f.name)
        for f in dataclasses.fields(P.ConformerLayerParams)})
    params = P.ModelParams(
        subsampling=group(P.SubsamplingParams, "sub."),
        layers=layers,
        decoder=group(P.DecoderParams, "dec."),
        joint=group(P.JointParams, "joint."),
        preproc=P.PreprocParams(filterbank=w["pre.filterbank"],
                                window=w["pre.window"]),
        pos_emb=w["pos_table"].to(act),
    )
    return ASRModel(hp, params, vocabulary(hp.vocab_size), device=device)
