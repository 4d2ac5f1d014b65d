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


@dataclasses.dataclass
class HeadShards:
    """A cache split on its head axis over one dp shard's tp devices
    (parallel/mesh.py): parts[t], dense or QuantKV, holds heads [t * H/n,
    (t + 1) * H/n) on the shard's t-th device, each part a buffer of its
    own (contiguous, as kernel B1 reads it)."""
    parts: list

    def __getitem__(self, i):
        """Leading-axis index of every part (a layer's views)."""
        return HeadShards([p[i] for p in self.parts])


def is_quant(buf) -> bool:
    if isinstance(buf, HeadShards):
        return is_quant(buf.parts[0])
    return isinstance(buf, QuantKV)


def kv_parts(buf) -> tuple:
    """The tensors of a cache buffer (an in-place op applies to each; the
    head shards' tensors one after another)."""
    if isinstance(buf, HeadShards):
        return tuple(t for p in buf.parts for t in kv_parts(p))
    return (buf.q, buf.s) if isinstance(buf, QuantKV) else (buf,)


def on_parts(tp, fn, *bufs):
    """fn(*bufs), once. With tp (a params.TPGroup whose devices hold the
    HeadShards parts of `bufs`), fn(*rank t's parts) on each rank's
    stream, forked from and joined to the lead's (TPGroup.each): every
    launch on a part lies on its rank's stream. Returns fn's result, or
    the ranks' results in rank order."""
    if tp is None:
        return fn(*bufs)
    return tp.each(lambda t: fn(*(b.parts[t] for b in bufs)))


def _shards(*bufs):
    """The HeadShards among `bufs`, as lists of parts (None if none is)."""
    if not isinstance(bufs[0], HeadShards):
        return None
    return zip(*(b.parts for b in bufs))


def quantize_kv(x) -> QuantKV:
    """[..., S, Dh] float -> QuantKV: per-frame max-abs scale over Dh, a scale
    of 1 on all-zero frames, divide, round half to even, clip to +-127."""
    if isinstance(x, HeadShards):
        return HeadShards([quantize_kv(p) for p in x.parts])
    x32 = x.float()
    s = x32.abs().amax(dim=-1) / 127.0
    safe = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(x32 / safe[..., None]), -127, 127)
    return QuantKV(q.to(torch.int8), s)


def dequantize_kv(buf: QuantKV, dtype=torch.float32):
    return (buf.q.float() * buf.s[..., None]).to(dtype)


def kv_zeros(shape, device) -> QuantKV:
    """Zero quantized buffer for a [..., S, Dh] `shape`."""
    return QuantKV(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(shape[:-1], dtype=torch.float32, device=device))


def kv_slice(buf, lo: int, hi: int, axis: int):
    """View of [lo, hi) along `axis`."""
    if isinstance(buf, HeadShards):
        return HeadShards([kv_slice(p, lo, hi, axis) for p in buf.parts])
    if is_quant(buf):
        return QuantKV(buf.q.narrow(axis, lo, hi - lo),
                       buf.s.narrow(axis, lo, hi - lo))
    return buf.narrow(axis, lo, hi - lo)


def kv_cat(bufs, axis: int):
    """Concatenation along `axis` (a new buffer)."""
    if isinstance(bufs[0], HeadShards):
        return HeadShards([kv_cat(list(ps), axis) for ps in _shards(*bufs)])
    if is_quant(bufs[0]):
        return QuantKV(torch.cat([b.q for b in bufs], dim=axis),
                       torch.cat([b.s for b in bufs], dim=axis))
    return torch.cat(bufs, dim=axis)


def kv_update_slice_(buf, new, lo: int, axis: int) -> None:
    """Write `new` into `buf` at [lo, lo + len) along `axis`, in place."""
    for t, n in zip(kv_parts(buf), kv_parts(new)):
        t.narrow(axis, lo, n.shape[axis]).copy_(n)


def kv_where(mask, new, old, batch_axis: int):
    """Per-slot select (a new buffer): `mask` [B] at `batch_axis`."""
    if isinstance(new, HeadShards):
        return HeadShards([kv_where(mask, n, o, batch_axis)
                           for n, o in _shards(new, old)])

    def g(n, o):
        m = mask.to(n.device).reshape((1,) * batch_axis + (-1,)
                         + (1,) * (n.dim() - batch_axis - 1))
        return torch.where(m, n, o)

    if is_quant(new):
        return QuantKV(g(new.q, old.q), g(new.s, old.s))
    return g(new, old)

