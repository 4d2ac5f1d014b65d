"""T=1 streaming attention core: the CUDA kernel `csrc/t1_attention.cu` and
its plain PyTorch version (port of nemotron_tpu/ops/attn_pallas.py, kernel B1).

    scores  = (q_u . [K_buf; k_new]) * scale + pos_mask     (f32)
    weights = softmax(scores)                               (f32)
    ctx     = weights . [V_buf; v_new]

K_buf / V_buf are dense tensors, or int8 `QuantKV` caches read as they are
(JAX ops/rel_attention.py:_t1_scores / _t1_context): the K scale multiplies
each score after the Dh reduction, the V scale multiplies the softmax
weight, and no dequantized copy of the cache is made.

A CUDA tensor goes through the kernel (or the call raises); a CPU tensor
takes `t1_attention_core_ref`. The kernel copies each (stream, head)'s K
and V rows into shared memory with bulk copies (`check_shape` says which
shapes it takes) on the plan of `attn_plan`.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from .. import kernels
from .kvquant import is_quant

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def t1_attention_core_ref(q_u, k_new, v_new, pos_mask, k_buf, v_buf):
    """Plain PyTorch version.

    q_u, k_new, v_new: [B, H, Dh]; pos_mask: [B, H, S_buf + 1] f32 (position
    scores * scale + additive mask); k_buf, v_buf: [B, H, S_buf, Dh] (read
    only), dense or QuantKV. Returns ctx [B, H, Dh] in q_u's dtype."""
    scale = 1.0 / math.sqrt(q_u.shape[-1])
    q = q_u.float()
    if is_quant(k_buf):
        content = torch.einsum("bhd,bhsd->bhs", q, k_buf.q.float()) * k_buf.s
    else:
        content = torch.einsum("bhd,bhsd->bhs", q, k_buf.float())
    c_new = (q * k_new.float()).sum(-1, keepdim=True)
    scores = torch.cat([content, c_new], dim=-1) * scale + pos_mask.float()
    w = torch.softmax(scores, dim=-1)
    if is_quant(v_buf):
        ctx = torch.einsum("bhs,bhsd->bhd", w[..., :-1] * v_buf.s,
                           v_buf.q.float())
    else:
        ctx = torch.einsum("bhs,bhsd->bhd", w[..., :-1], v_buf.float())
    ctx = ctx + w[..., -1:] * v_new.float()
    return ctx.to(q_u.dtype)


# Shared memory of an H100: what one block may use (opt-in), what an SM
# holds, and what the SM keeps back for each resident block.
SMEM_BLOCK = 232_448
SMEM_SM = 233_472
SMEM_RESERVED = 1024
MAX_CLUSTER = 4  # blocks that split one (stream, head)'s slots, at most
D_HEADS = (16, 32, 64, 128)  # the head widths the kernels are compiled for


def r16(x: int) -> int:
    return (x + 15) // 16 * 16


def tile_bytes(n: int, d_head: int, elem: int) -> int:
    """Bytes of one copy of n cache rows in shared memory (K or V)."""
    return (n * d_head * elem + 127) // 128 * 128


def b1_smem(n: int, d_head: int, elem: int, act: int) -> int:
    """Shared memory of one B1 block over n slots of the (stream, head),
    with cache elements of `elem` bytes and activations of `act`: the K and
    V tiles, q, k_new, v_new, the position terms and (int8) the scales; the
    weights, the context partials, the cluster's combination area and the
    barriers (csrc/t1_attention.cu's Layout)."""
    return (2 * tile_bytes(n, d_head, elem) + 3 * r16(d_head * act)
            + r16((n + 1) * 4) + (2 * r16(n * 4) if elem == 1 else 0)
            + r16((n + 1) * 4) + 8192 // elem + r16((2 + d_head) * 4) + 16)


@functools.lru_cache(maxsize=None)
def check_shape(d_head: int, elem: int, s_buf: int) -> None:
    """The shapes the bulk-copy body takes (elem: bytes of a cache element,
    4 f32, 2 bf16, 1 int8): d_head one of D_HEADS (the kernels' compiled
    widths; each cache row is then a power-of-two count, 1 to 32, of
    16-byte chunks: the copy's granule, and the 16-byte shared-memory reads,
    one lane per chunk), and the buffer's K and V rows fit a block. Raises
    ValueError on anything else."""
    if d_head not in D_HEADS:
        raise ValueError(f"t1_attention_core: d_head {d_head} is not one of "
                         f"the compiled widths {D_HEADS}")
    if s_buf < 1 or b1_smem(s_buf, d_head, elem, 4) > SMEM_BLOCK:
        raise ValueError(f"t1_attention_core: s_buf {s_buf} does not fit "
                         f"one block's shared memory")


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    """How B1 covers batch*heads pairs: a block per pair, or with `cluster`
    > 1 one pair's slots split over a cluster of that many blocks
    (ceil(s_buf / cluster) each)."""
    cluster: int
    blocks: int


@functools.lru_cache(maxsize=None)
def attn_plan(pairs: int, s_buf: int, sms: int) -> AttnPlan:
    """The plan of one B1 call on a card with `sms` SMs: a block per
    (stream, head) pair; with fewer pairs than SMs, a cluster of 2 or 4
    blocks per pair while the clusters still leave SMs idle (every block
    keeps at least one slot)."""
    cluster = 1
    while (cluster < MAX_CLUSTER and pairs * cluster < sms
           and -(-s_buf // (2 * cluster)) * (2 * cluster - 1) < s_buf):
        cluster *= 2
    return AttnPlan(cluster, pairs * cluster)


_SMS: dict = {}


def sm_count(device) -> int:
    """The card's SM count (cached per device)."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device:
        raise ValueError(
            f"t1_attention_core: {name} {tuple(t.shape)} {t.dtype} on "
            f"{t.device}, want {tuple(shape)} {dtype} on {device}")


def t1_attention_core(q_u, k_new, v_new, pos_mask, k_buf, v_buf):
    """Fused T=1 attention against the full slack buffer (kernel on CUDA)."""
    quant = is_quant(k_buf)
    if quant != is_quant(v_buf):
        raise ValueError("t1_attention_core: K and V caches differ in kind")
    dev = (k_buf.q if quant else k_buf).device
    if dev.type == "cpu":
        return t1_attention_core_ref(q_u, k_new, v_new, pos_mask, k_buf, v_buf)
    if dev.type != "cuda":
        raise ValueError(f"t1_attention_core: unsupported device {dev}")
    dt = q_u.dtype
    if dt not in _SUFFIX:
        raise ValueError(f"t1_attention_core: unsupported dtype {dt}")
    b, h, dh = q_u.shape
    if quant:
        s_buf = k_buf.q.shape[2]
        caches = (k_buf.q, k_buf.s, v_buf.q, v_buf.s)
        for name, t in zip(("k_buf.q", "k_buf.s", "v_buf.q", "v_buf.s"),
                           caches):
            shape = (b, h, s_buf, dh) if name.endswith("q") else (b, h, s_buf)
            _check(name, t, shape,
                   torch.int8 if name.endswith("q") else torch.float32, dev)
    else:
        s_buf = k_buf.shape[2]
        caches = (k_buf, v_buf)
        for name, t in (("k_buf", k_buf), ("v_buf", v_buf)):
            _check(name, t, (b, h, s_buf, dh), dt, dev)
    for name, t, shape, want in (
            ("q_u", q_u, (b, h, dh), dt), ("k_new", k_new, (b, h, dh), dt),
            ("v_new", v_new, (b, h, dh), dt),
            ("pos_mask", pos_mask, (b, h, s_buf + 1), torch.float32)):
        _check(name, t, shape, want, dev)
    if not all(t.is_contiguous() for t in caches):
        raise ValueError("t1_attention_core: K/V buffers must be contiguous")
    elem = 1 if quant else caches[0].element_size()
    check_shape(dh, elem, s_buf)
    codes = (k_buf.q, v_buf.q) if quant else caches
    if any(t.data_ptr() % 16 for t in codes):
        raise ValueError("t1_attention_core: K/V buffers must be 16-byte "
                         "aligned (bulk copies)")
    plan = attn_plan(b * h, s_buf, sm_count(dev))
    # q, k_new and v_new are staged by bulk copies: 16-byte aligned rows
    q_u, k_new, v_new = (t.contiguous() if t.data_ptr() % 16 == 0
                         and t.is_contiguous() else t.clone(
                             memory_format=torch.contiguous_format)
                         for t in (q_u, k_new, v_new))
    pos_mask = pos_mask.contiguous()
    out = torch.empty((b, h, dh), dtype=dt, device=dev)
    symbol = ("t1_attention_i8_" if quant else "t1_attention_") + _SUFFIX[dt]
    kernels.T1_ATTENTION.launch(
        symbol, q_u.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        pos_mask.data_ptr(), *(t.data_ptr() for t in caches), out.data_ptr(),
        b * h, s_buf, dh, 1.0 / math.sqrt(dh), plan.cluster)
    return out
