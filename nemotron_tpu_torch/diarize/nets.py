"""MarbleNet VAD and TitaNet-L forward passes, batched over windows (port of
nemotron_tpu/diarize/nets.py, the same semantics): a per-time mask before
every convolution (NeMo MaskedConv1d), SE before the residual, ReLU between
repeats, the VAD decoder's mean-pool over all padded frames, attentive
statistics pooling with masked mean / std.

Activations are [B, C, T]: a depthwise convolution is F.conv1d with
groups=C, a pointwise one and every linear a torch.matmul, BN a pre-folded
scale and bias. f32 throughout, with TF32 off (set here as in api.py, so
that the nets hold f32 numerics without the ASR model's import)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .audio import HOP, SPK_MEL_VALID, VAD_MEL_VALID, logmel
from .params import SPK_TOPOLOGY, VAD_TOPOLOGY, SpkParams, VadParams

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def depthwise_same(x: torch.Tensor, dw: torch.Tensor,
                   dilation: int) -> torch.Tensor:
    """x [B, C, T]; dw [k, C]; 'same' padding with dilation."""
    k, c = dw.shape
    if k == 1:
        return x * dw[0][:, None]
    return F.conv1d(x, dw.T.unsqueeze(1), padding=dilation * (k - 1) // 2,
                    dilation=dilation, groups=c)


def subconv(x, mask, sub, dilation: int):
    """mask [B, 1, T]. Masked (dw ->) pw -> folded BN."""
    y = x
    if sub.dw is not None:
        y = depthwise_same(y * mask, sub.dw, dilation)
    y = torch.matmul(sub.pw, y * mask)
    return y * sub.bn_scale[:, None] + sub.bn_bias[:, None]


def jasper_block(x, mask, block, dilation: int, inv_lens=None):
    x_in = x
    cur = x
    n = len(block.subs)
    for i, s in enumerate(block.subs):
        cur = subconv(cur, mask, s, dilation)
        if i + 1 < n:
            cur = torch.relu(cur)
    if block.se_fc1 is not None:
        xm = cur * mask
        mean = xm.sum(dim=2) * inv_lens[:, None]               # [B, C]
        g = torch.relu(mean @ block.se_fc1.T)
        g = torch.sigmoid(g @ block.se_fc2.T)                  # [B, C]
        cur = xm * g[:, :, None]
    if block.res is not None:
        cur = cur + subconv(x_in, mask, block.res, 1)
    return torch.relu(cur)


def _encoder(x, mask, blocks, topology, inv_lens=None):
    for block, topo in zip(blocks, topology):
        x = jasper_block(x, mask, block, dilation=topo[1], inv_lens=inv_lens)
    return x


def _mask(lens_mel: torch.Tensor, t: int, dtype) -> torch.Tensor:
    ar = torch.arange(t, device=lens_mel.device)
    return (ar[None, :] < lens_mel[:, None]).to(dtype)[:, None, :]


@torch.no_grad()
def vad_probs(params: VadParams, windows: torch.Tensor,
              lens_samples: torch.Tensor) -> torch.Tensor:
    """windows [B, 10080] f32 audio; lens_samples [B] int real samples.
    Returns [B] P(speech)."""
    mel = logmel(windows, params.fb, params.window, per_feature_norm=False)
    t = mel.shape[1]  # 64
    lens_mel = torch.clamp(lens_samples // HOP, 0, VAD_MEL_VALID)
    mask = _mask(lens_mel, t, mel.dtype)
    enc = _encoder(mel.transpose(1, 2), mask, params.blocks, VAD_TOPOLOGY)
    pooled = enc.mean(dim=2)  # AdaptiveAvgPool1d over all padded frames
    logits = pooled @ params.dec_w.T + params.dec_b
    return torch.softmax(logits, dim=-1)[:, 1]


@torch.no_grad()
def spk_embed(params: SpkParams, windows: torch.Tensor,
              lens_samples: torch.Tensor) -> torch.Tensor:
    """windows [B, 24000] f32 audio; lens [B] int. Returns [B, 192]."""
    mel = logmel(windows, params.fb, params.window, per_feature_norm=True)
    t = mel.shape[1]  # 160
    lens_mel = torch.clamp(lens_samples // HOP, 1, SPK_MEL_VALID)
    mask = _mask(lens_mel, t, mel.dtype)                        # [B, 1, T]
    inv_lens = 1.0 / lens_mel.to(mel.dtype)

    enc = _encoder(mel.transpose(1, 2), mask, params.blocks, SPK_TOPOLOGY,
                   inv_lens=inv_lens)
    xm = enc * mask                                             # [B, C, T]

    d = params.dec
    mean = xm.sum(dim=2) * inv_lens[:, None]                    # [B, C]
    diff = (xm - mean[:, :, None]) * mask
    var = (diff ** 2).sum(dim=2) * inv_lens[:, None]
    std = torch.sqrt(torch.clamp(var, min=1e-10))               # [B, C]

    b, c, tt = xm.shape
    cat = torch.cat([xm, mean[:, :, None].expand(b, c, tt),
                     std[:, :, None].expand(b, c, tt)], dim=1)  # [B, 3C, T]
    a = torch.matmul(d.attn1_w, cat) + d.attn1_b[:, None]
    a = torch.relu(a)
    a = a * d.attn_bn_scale[:, None] + d.attn_bn_bias[:, None]
    a = torch.tanh(a)
    a = torch.matmul(d.attn2_w, a) + d.attn2_b[:, None]         # [B, C, T]
    a = a + torch.where(mask > 0, 0.0, -1e9)
    alpha = torch.softmax(a, dim=2)                             # over T

    mu = (xm * alpha).sum(dim=2)                                # [B, C]
    sg = torch.sqrt(torch.clamp(
        ((xm - mu[:, :, None]) ** 2 * alpha).sum(dim=2), min=1e-10))
    pool = torch.cat([mu, sg], dim=-1)                          # [B, 2C]
    e = pool * d.emb_bn_scale + d.emb_bn_bias
    return e @ d.emb_w.T + d.emb_b                              # [B, 192]
