"""Int8 attention K/V caches (port of nemotron_tpu/ops/kvquant.py).

A cache buffer is either a dense tensor [..., S, Dh] or a `QuantKV`: int8
codes q [..., S, Dh] and one f32 scale per frame s [..., S], value q * s.
Each frame is quantized over its Dh elements (max-abs / 127) when it is
written into the cache; the new frame's own K/V stay in the activation type
for the attention that produces them. Kernel B1 reads q and s directly and
never writes a dequantized copy (ops/attn_kernel.py).

The JAX package selects int8 caches with an environment variable; the port
takes an explicit `kv_int8` argument (ASRModel, init_stream_state).

The structural helpers work on both kinds of buffer; `axis` names an axis of
the q tensor that lies before Dh, so it is the same axis of s. The port
updates the caches in place where the JAX package returns new buffers.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QuantKV:
    q: torch.Tensor  # int8 [..., S, Dh]
    s: torch.Tensor  # f32 [..., S]

    def __getitem__(self, i):
        """Leading-axis index (a layer's view of the stacked cache)."""
        return QuantKV(self.q[i], self.s[i])


def is_quant(buf) -> bool:
    return isinstance(buf, QuantKV)


def kv_parts(buf) -> tuple:
    """The tensors of a cache buffer (an in-place op applies to each)."""
    return (buf.q, buf.s) if is_quant(buf) else (buf,)


def quantize_kv(x) -> QuantKV:
    """[..., S, Dh] float -> QuantKV: per-frame max-abs scale over Dh, a scale
    of 1 on all-zero frames, divide, round half to even, clip to +-127."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1) / 127.0
    safe = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(x32 / safe[..., None]), -127, 127)
    return QuantKV(q.to(torch.int8), s)


def dequantize_kv(buf: QuantKV, dtype=torch.float32):
    return (buf.q.float() * buf.s[..., None]).to(dtype)


def kv_zeros(shape, device="cpu") -> QuantKV:
    """Zero quantized buffer for a [..., S, Dh] `shape`."""
    return QuantKV(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(shape[:-1], dtype=torch.float32, device=device))


def kv_slice(buf, lo: int, hi: int, axis: int):
    """View of [lo, hi) along `axis`."""
    if is_quant(buf):
        return QuantKV(buf.q.narrow(axis, lo, hi - lo),
                       buf.s.narrow(axis, lo, hi - lo))
    return buf.narrow(axis, lo, hi - lo)


def kv_update_slice_(buf, new, lo: int, axis: int) -> None:
    """Write `new` into `buf` at [lo, lo + len) along `axis`, in place."""
    for t, n in zip(kv_parts(buf), kv_parts(new)):
        t.narrow(axis, lo, n.shape[axis]).copy_(n)


def kv_where(mask, new, old, batch_axis: int):
    """Per-slot select (a new buffer): `mask` [B] at `batch_axis`."""

    def g(n, o):
        m = mask.reshape((1,) * batch_axis + (-1,)
                         + (1,) * (n.dim() - batch_axis - 1))
        return torch.where(m, n, o)

    if is_quant(new):
        return QuantKV(g(new.q, old.q), g(new.s, old.s))
    return g(new, old)

