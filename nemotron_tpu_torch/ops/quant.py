"""Weight-only Q8_0 / Q4_0 linears: the CUDA kernels `csrc/q8_matmul.cu`
(B4) and `csrc/q4_matmul.cu` (B5) and their plain PyTorch versions (port of
nemotron_tpu/ops/quant.py).

A Q8_0 weight is (w_i8 [..., out, in] int8, scales [..., out, in/32] f32):
element (n, k) is w_i8[n, k] * scales[n, k // 32]. A Q4_0 weight keeps the
JAX package's half-split packing: w_packed [..., out, in/2] uint8 holds
original column k < in/2 in the low nibble of packed column k and column
k >= in/2 in the high nibble of packed column k - in/2; its value is
(nibble - 8) * scales[n, k // 32]. Both accept a leading [L] axis and index
by layer.

The plain versions dequantize to x's dtype and call F.linear, as the JAX
package's default `linear_q8_xla` / `linear_q4_xla` do. A CUDA weight goes
through its kernel (or the call raises); a CPU weight takes the plain
version. The quantizers run in numpy, so both packages produce the same
bits from the same f32 weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels

QBLOCK = 32


@dataclasses.dataclass
class QuantizedTensor:
    w_i8: torch.Tensor    # [..., out, in] int8
    scales: torch.Tensor  # [..., out, in // 32] f32

    def __getitem__(self, i):
        return QuantizedTensor(self.w_i8[i], self.scales[i])

    def to(self, device):
        return QuantizedTensor(self.w_i8.to(device), self.scales.to(device))


@dataclasses.dataclass
class QuantizedTensor4:
    w_packed: torch.Tensor  # [..., out, in // 2] uint8, half-split nibbles
    scales: torch.Tensor    # [..., out, in // 32] f32, original-order blocks

    def __getitem__(self, i):
        return QuantizedTensor4(self.w_packed[i], self.scales[i])

    def to(self, device):
        return QuantizedTensor4(self.w_packed.to(device),
                                self.scales.to(device))


def is_quantized(w) -> bool:
    return isinstance(w, (QuantizedTensor, QuantizedTensor4))


def _blocks(w, multiple: int):
    w = np.asarray(w, np.float32)
    if w.shape[-1] % multiple:
        raise ValueError(f"input width {w.shape[-1]} is not a multiple of "
                         f"{multiple}")
    blocks = w.reshape(*w.shape[:-1], w.shape[-1] // QBLOCK, QBLOCK)
    return w.shape, np.abs(blocks).max(axis=-1), blocks


def quantize_q8(w) -> QuantizedTensor:
    """Quantize [..., out, in] to Q8_0 blocks (amax/127 per 32 inputs)."""
    shape, amax, blocks = _blocks(w, QBLOCK)
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(blocks / scales[..., None]), -127, 127).astype(np.int8)
    return QuantizedTensor(torch.from_numpy(q.reshape(shape)),
                           torch.from_numpy(scales))


def from_gguf_q8(raw: bytes, out: int, inp: int) -> QuantizedTensor:
    """A QuantizedTensor straight from a raw GGUF Q8_0 payload."""
    block = np.dtype([("scale", np.float16), ("q", np.int8, QBLOCK)])
    arr = np.frombuffer(raw, dtype=block, count=out * inp // QBLOCK)
    return QuantizedTensor(
        torch.from_numpy(arr["q"].reshape(out, inp).copy()),
        torch.from_numpy(arr["scale"].astype(np.float32).reshape(
            out, inp // QBLOCK)))


def dequantize(qt: QuantizedTensor, dtype=torch.float32):
    scales = qt.scales.repeat_interleave(QBLOCK, dim=-1)
    return (qt.w_i8.float() * scales).to(dtype)


def _pack_half_split(qu: np.ndarray) -> np.ndarray:
    """[..., out, in] nibble values (0..15) -> half-split packed bytes."""
    half = qu.shape[-1] // 2
    return ((qu[..., :half] & 0x0F) | (qu[..., half:] << 4)).astype(np.uint8)


def quantize_q4(w) -> QuantizedTensor4:
    """Quantize [..., out, in] to Q4_0 semantics (amax/7 per 32-block,
    values in [-8, 7] stored as nibble + 8); in % 64 == 0."""
    shape, amax, blocks = _blocks(w, 2 * QBLOCK)
    scales = np.where(amax > 0, amax / 7.0, 1.0).astype(np.float32)
    q = np.clip(np.round(blocks / scales[..., None]), -8, 7).astype(np.int8)
    qu = (q + 8).astype(np.uint8).reshape(shape)
    return QuantizedTensor4(torch.from_numpy(_pack_half_split(qu)),
                            torch.from_numpy(scales))


def from_gguf_q4(raw: bytes, out: int, inp: int) -> QuantizedTensor4:
    """A QuantizedTensor4 from a raw GGUF Q4_0 payload (repacked from GGUF's
    per-block low/high nibble order to the half-split layout)."""
    block = np.dtype([("scale", np.float16), ("q", np.uint8, QBLOCK // 2)])
    arr = np.frombuffer(raw, dtype=block, count=out * inp // QBLOCK)
    qu = np.concatenate([arr["q"] & 0x0F, arr["q"] >> 4], axis=1)
    return QuantizedTensor4(
        torch.from_numpy(_pack_half_split(qu.reshape(out, inp))),
        torch.from_numpy(arr["scale"].astype(np.float32).reshape(
            out, inp // QBLOCK)))


def dequantize_q4(qt: QuantizedTensor4, dtype=torch.float32):
    w32 = qt.w_packed.to(torch.int32)
    vals = torch.cat([(w32 & 0x0F) - 8, (w32 >> 4) - 8], dim=-1).float()
    scales = qt.scales.repeat_interleave(QBLOCK, dim=-1)
    return (vals * scales).to(dtype)


def linear_q8_ref(x, qt: QuantizedTensor):
    """Plain version: dequantize to x.dtype, then x @ w.T."""
    return F.linear(x, dequantize(qt, x.dtype))


def linear_q4_ref(x, qt: QuantizedTensor4):
    return F.linear(x, dequantize_q4(qt, x.dtype))


_SYMBOL = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _launch(kernel, prefix, x, w, scales, n, k, k_multiple):
    """Shared wrapper of B4 / B5: checks, then one launch over x [M, K]."""
    name = kernel.name
    if x.dtype not in _SYMBOL:
        raise ValueError(f"{name}: unsupported activation dtype {x.dtype}")
    if k % k_multiple:
        raise ValueError(f"{name}: K={k} is not a multiple of {k_multiple}")
    if x.shape[-1] != k:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match K={k}")
    if w.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"{name}: weights must be 2-D (index the layer first)")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (n, k // QBLOCK):
        raise ValueError(f"{name}: scales {tuple(scales.shape)} "
                         f"{scales.dtype}, want {(n, k // QBLOCK)} float32")
    for t in (w, scales):
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: weights must be contiguous")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:  # the kernel reads x in 16-byte vectors
        x2 = x2.clone()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m:
        kernel.launch(f"{prefix}_{_SYMBOL[x.dtype]}", x2.data_ptr(),
                      w.data_ptr(), scales.data_ptr(), out.data_ptr(), m, n, k)
    return out.reshape(*lead, n)


def linear_q8(x, qt: QuantizedTensor):
    """x @ dequantize(qt).T: kernel B4 on CUDA, the plain version on CPU."""
    if qt.w_i8.device.type == "cpu":
        return linear_q8_ref(x, qt)
    if qt.w_i8.device.type != "cuda":
        raise ValueError(f"linear_q8: unsupported device {qt.w_i8.device}")
    if qt.w_i8.dtype != torch.int8:
        raise ValueError(f"linear_q8: weights are {qt.w_i8.dtype}, want int8")
    n, k = qt.w_i8.shape[-2:]
    return _launch(kernels.Q8_MATMUL, "q8_matmul", x, qt.w_i8, qt.scales,
                   n, k, QBLOCK)


def linear_q4(x, qt: QuantizedTensor4):
    """x @ dequantize_q4(qt).T: kernel B5 on CUDA, the plain version on CPU."""
    if qt.w_packed.device.type == "cpu":
        return linear_q4_ref(x, qt)
    if qt.w_packed.device.type != "cuda":
        raise ValueError(f"linear_q4: unsupported device {qt.w_packed.device}")
    if qt.w_packed.dtype != torch.uint8:
        raise ValueError(
            f"linear_q4: weights are {qt.w_packed.dtype}, want uint8")
    n, k = qt.w_packed.shape[-2], qt.w_packed.shape[-1] * 2
    return _launch(kernels.Q4_MATMUL, "q4_matmul", x, qt.w_packed, qt.scales,
                   n, k, 2 * QBLOCK)
