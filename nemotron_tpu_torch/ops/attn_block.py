"""The fused T=1 attention block of one conformer layer: the CUDA kernel
`csrc/t1_attention_block.cu` and its plain PyTorch version (port of
nemotron_tpu/ops/attn_block_pallas.py, kernel B3).

    y        = LN(x)                                   (f32, cast to x's type)
    q, k, v  = y . Wq^T, y . Wk^T, y . Wv^T            (f32 sums; q stays f32)
    scores   = content * scale + ((q + bias_v) . pp + new-frame score) * scale
               + mask                                  (f32)
    ctx      = softmax(scores) . [V_buf; v]            (f32, cast to x's type)
    out      = x + ctx . Wo^T                          (f32 sum, cast once)

Returns (out [B, D], k_new, v_new [B, H, Dh] in x's type); the caller
appends k_new / v_new to the cache. The heads may be a tp shard's
(parallel/mesh.py): H * Dh = E need not be D, the projections are then
[E, D] and the out projection [D, E], and with residual=False `out` is the
shard's partial product ctx . Wo^T alone (cast once), which the caller sums
over the shards before it adds the residual once. K_buf / V_buf are dense tensors, or
int8 `QuantKV` caches read as they are, as kernel B1 reads them
(ops/attn_kernel.py): the K scale multiplies each content score after the
Dh reduction and the V scale multiplies the softmax weight. The JAX
package dequantizes first; the values agree up to rounding order.

A CUDA tensor goes through the kernel (or the call raises); a CPU tensor
takes `t1_attention_block_ref`. The kernel's bf16 projections run on the
plans of `block_gemm_plans`, its f32 ones on `block_f32_plans`', its
attention launch on `attn_group`'s.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from .. import kernels
from .attn_kernel import (SMEM_BLOCK, SMEM_RESERVED, SMEM_SM, r16,
                          check_shape, sm_count, tile_bytes)
from .kvquant import is_quant
from .quant import (GEMM_M_TILES, GEMM_ROWS, GEMM_STEP, _ptr, f32_plan,
                    f32_scratch)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def t1_attention_block_ref(x, ln_w, ln_b, q_w, k_w, v_w, out_w, bias_u,
                           bias_v, pp, mask, k_buf, v_buf, n_heads: int,
                           d_head: int, eps: float = 1e-5,
                           residual: bool = True):
    """Plain PyTorch version, with the Pallas kernel's rounding points.

    x [B, D]; ln_w/ln_b [D]; q/k/v_w [E, D] and out_w [D, E] (out, in) with
    E = H * Dh; bias_u/v [H, Dh]; pp [H, Dh, S_buf + 1] f32; mask [B, S_buf
    + 1] additive; k_buf/v_buf [B, H, S_buf, Dh] dense or QuantKV (read
    only). residual=False leaves x out of `out`."""
    B, D = x.shape
    H, Dh = n_heads, d_head
    dt = x.dtype
    scale = 1.0 / math.sqrt(Dh)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps) * ln_w.float()
         + ln_b.float()).to(dt).float()
    q = (y @ q_w.float().T).view(B, H, Dh)
    kn = (y @ k_w.float().T).view(B, H, Dh)
    vn = (y @ v_w.float().T).view(B, H, Dh)
    q_u = q + bias_u.float()
    q_v = q + bias_v.float()
    nsc = (q_u * kn).sum(-1)                                  # [B, H]
    pos = torch.einsum("bhd,hds->bhs", q_v, pp.float())       # [B, H, S+1]
    pos[..., -1] += nsc
    pos = pos * scale + mask.float()[:, None, :]
    if is_quant(k_buf):
        content = torch.einsum("bhd,bhsd->bhs", q_u, k_buf.q.float()) \
            * k_buf.s
    else:
        content = torch.einsum("bhd,bhsd->bhs", q_u, k_buf.float())
    scores = torch.cat([content, torch.zeros_like(nsc)[..., None]], -1) \
        * scale + pos
    w = torch.softmax(scores, dim=-1)
    if is_quant(v_buf):
        ctx = torch.einsum("bhs,bhsd->bhd", w[..., :-1] * v_buf.s,
                           v_buf.q.float())
    else:
        ctx = torch.einsum("bhs,bhsd->bhd", w[..., :-1], v_buf.float())
    ctx = ctx + w[..., -1:] * vn
    out = ctx.to(dt).float().reshape(B, H * Dh) @ out_w.float().T
    if residual:
        out = xf + out
    return out.to(dt), kn.to(dt), vn.to(dt)


# The bf16 projections (csrc/wq_gemm_sm90.cuh, gemm_dense_sm90): blocks of
# GEMM_ROWS weight rows, steps of GEMM_STEP columns, batch tiles of one of
# GEMM_M_TILES rows (the QKV GEMM's resident LN operand keeps them <= 64).
# The launcher gives the ring as many stages as fit, at least 2.
QKV_MAX_TILE = 64
STAGING_LD = GEMM_ROWS + 4  # floats per row of the epilogue's staging


def dense_smem(ln: bool, nt: int, steps: int, stages: int) -> int:
    """Shared memory of one projection block (csrc/wq_gemm_sm90.cuh's
    dense_smem): alignment slack, the ring (or the epilogue's staging,
    the larger), with `ln` the resident operand (the block's x rows, all
    `steps` atoms of 64 columns), its row statistics and barrier, and the
    ring's barriers. The QKV plan picks its batch tile by it."""
    ring = stages * (GEMM_ROWS * 128 + (0 if ln else nt * 128))
    region = -(-max(ring, nt * STAGING_LD * 4) // 1024) * 1024
    return (1024 + region + (nt * 128 * steps + nt * 8 + 8 if ln else 0)
            + 16 * stages)


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """One projection launch: batch tiles of nt rows (tiles_m of them),
    tiles_n weight-row tiles (for QKV, ceil(D / 128) in each of q, k, v:
    none straddles two), `steps` steps of GEMM_STEP columns in `splits`
    runs of steps_per (none empty)."""
    nt: int
    tiles_m: int
    tiles_n: int
    splits: int
    steps: int
    steps_per: int

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n * self.splits


def _tile(rows: int) -> int:
    return min(t for t in GEMM_M_TILES if t >= max(1, rows))


@functools.lru_cache(maxsize=None)
def block_gemm_plans(m: int, d: int, sms: int, e: int | None = None):
    """The plans of B3's two bf16 projections for m streams at d_model d
    and e = H * Dh (d where None; a tp shard's heads give less) on a card
    with `sms` SMs: (qkv, out).

    QKV: batch tiles of at most 64 rows, as large as let a ring of two
    stages fit beside the block's resident x rows (nt x d in bf16), then
    split-K while the blocks leave SMs idle, at least one step per split;
    the attention launch adds the splits' partials in split order. Out: one
    split (the residual is added in the epilogue), batch tiles as small as
    it takes to give the SMs a block each."""
    e = d if e is None else e
    steps = -(-d // GEMM_STEP)
    tiles_n = 3 * -(-e // GEMM_ROWS)
    tiles_m = -(-m // QKV_MAX_TILE)
    while dense_smem(True, _tile(-(-m // tiles_m)), steps, 2) > SMEM_BLOCK:
        tiles_m += 1
    nt = _tile(-(-m // tiles_m))
    want = max(1, sms // (tiles_n * tiles_m))
    steps_per = -(-steps // min(want, steps))
    qkv = DensePlan(nt, tiles_m, tiles_n, -(-steps // steps_per), steps,
                    steps_per)
    out_n = -(-d // GEMM_ROWS)
    nt = _tile(-(-m // max(1, sms // out_n)))
    out_steps = -(-e // GEMM_STEP)
    return qkv, DensePlan(nt, -(-m // nt), out_n, 1, out_steps, out_steps)


MAX_GROUPS = 4  # groups of 128 threads per attention block, at most
MAX_QKV_SPLITS = 8  # f32 QKV splits, at most


def attn_smem(s_buf: int, d_head: int, elem: int, stages: int,
              splits: int, groups: int) -> int:
    """Shared memory of one attention block of B3 (csrc/
    t1_attention_block.cu's Layout): pp[h], the biases and pp's barrier;
    per group `stages` stages of K and V tiles, the stream's q, k, v sums
    of each of the QKV GEMM's `splits` and (int8) the scales, then the
    per-stream vectors, the position and context partials and barriers."""
    s1 = r16((s_buf + 1) * 4)
    stage = (2 * tile_bytes(s_buf, d_head, elem) + 3 * splits
             * r16(d_head * 4) + (2 * r16(s_buf * 4) if elem == 1 else 0))
    group = (stages * stage + 4 * r16(d_head * 4) + 2 * s1 + 4 * s1
             + 8192 // elem + 16 + 16 * stages)
    shared = (-(-d_head * (s_buf + 1) * 4 // 128) * 128
              + 2 * r16(d_head * 4) + 16)
    return shared + groups * group


@dataclasses.dataclass(frozen=True)
class AttnGroupPlan:
    """B3's attention launch: per_block streams of one head per block,
    taken in turn by its `groups` groups of 128 threads, each with a ring
    of `stages`."""
    per_block: int
    groups: int
    stages: int
    per_sm: int  # blocks an SM holds at once

    def blocks(self, b: int, h: int) -> int:
        return h * -(-b // self.per_block)


@functools.lru_cache(maxsize=None)
def attn_group(b: int, h: int, s_buf: int, d_head: int, elem: int,
               splits: int, sms: int) -> AttnGroupPlan:
    """The plan of B3's attention launch: the most stream buffers (groups x
    stages, 2 groups of 2 stages first) that fit a block (attn_smem), up to
    MAX_GROUPS groups; then just enough streams per block that the blocks
    an SM holds at once cover every (stream, head) in one wave, and no
    more groups than streams. Raises ValueError where not even two groups
    of one stage fit."""
    fits = [(g * st, g, st) for st in (2, 1) for g in range(2, MAX_GROUPS + 1)
            if attn_smem(s_buf, d_head, elem, st, splits, g) <= SMEM_BLOCK]
    if not fits:
        raise ValueError(f"t1_attention_block: s_buf {s_buf} x d_head "
                         f"{d_head} does not fit one block's shared memory")
    _, groups, stages = max(fits, key=lambda f: (f[0], -f[1]))
    smem = attn_smem(s_buf, d_head, elem, stages, splits, groups)
    per_sm = max(1, min(16 // groups, SMEM_SM // (smem + SMEM_RESERVED)))
    per_block = max(1, -(-(b * h) // (per_sm * sms)))
    groups = min(groups, per_block)  # no group without a stream
    return AttnGroupPlan(per_block, groups, stages, per_sm)


@functools.lru_cache(maxsize=None)
def block_f32_plans(m: int, d: int, s_buf: int, d_head: int, elem: int,
                    sms: int, e: int | None = None):
    """The plans of B3's two f32 projections (the FFMA body of
    csrc/wq_matmul.cuh, ops/quant.py:f32_plan) for m streams at d_model d
    and e = H * Dh (d where None) on a card with `sms` SMs: (qkv, out). The QKV splits go to their own
    slices of the qkv scratch, which the attention launch adds in split
    order, so they are capped where its smallest configuration (attn_smem:
    2 groups of 1 stage, elem bytes per cache element) still fits a block;
    the out projection's splits are summed in the kernel."""
    cap = max([z for z in range(1, MAX_QKV_SPLITS + 1)
               if attn_smem(s_buf, d_head, elem, 1, z, 2) <= SMEM_BLOCK],
              default=1)
    e = d if e is None else e
    return (f32_plan(m, 3 * e, d, sms, cap), f32_plan(m, d, e, sms))


def _check(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor) or tuple(t.shape) != tuple(shape) \
            or t.dtype != dtype or t.device != device:
        desc = (f"{tuple(t.shape)} {t.dtype} on {t.device}"
                if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"t1_attention_block: {name} {desc}, want "
                         f"{tuple(shape)} {dtype} on {device}")


def t1_attention_block(x, ln_w, ln_b, q_w, k_w, v_w, out_w, bias_u, bias_v,
                       pp, mask, k_buf, v_buf, n_heads: int, d_head: int,
                       eps: float = 1e-5, residual: bool = True):
    """The fused attention block for one layer at T=1 (kernel on CUDA).
    Returns (x + attn [B, D], k_new [B, H, Dh], v_new [B, H, Dh]); with
    residual=False the first is attn alone (a tp shard's partial)."""
    quant = is_quant(k_buf)
    if quant != is_quant(v_buf):
        raise ValueError("t1_attention_block: K and V caches differ in kind")
    dev = x.device
    if dev.type == "cpu":
        return t1_attention_block_ref(x, ln_w, ln_b, q_w, k_w, v_w, out_w,
                                      bias_u, bias_v, pp, mask, k_buf, v_buf,
                                      n_heads, d_head, eps, residual)
    if dev.type != "cuda":
        raise ValueError(f"t1_attention_block: unsupported device {dev}")
    dt = x.dtype
    if dt not in _SUFFIX:
        raise ValueError(f"t1_attention_block: unsupported dtype {dt}")
    B, D = x.shape
    H, Dh = n_heads, d_head
    E = H * Dh
    if D % 32 or E % 32:  # the GEMMs walk K in steps of 32
        raise ValueError(f"t1_attention_block: d_model {D} and n_heads * "
                         f"d_head = {E} must be multiples of 32")
    if quant:
        s_buf = k_buf.q.shape[2]
        caches = (k_buf.q, k_buf.s, v_buf.q, v_buf.s)
        for name, t in zip(("k_buf.q", "k_buf.s", "v_buf.q", "v_buf.s"),
                           caches):
            code = name.endswith("q")
            _check(name, t, (B, H, s_buf, Dh) if code else (B, H, s_buf),
                   torch.int8 if code else torch.float32, dev)
    else:
        s_buf = k_buf.shape[2]
        caches = (k_buf, v_buf)
        for name, t in (("k_buf", k_buf), ("v_buf", v_buf)):
            _check(name, t, (B, H, s_buf, Dh), dt, dev)
    for name, t, shape, want in (
            ("ln_w", ln_w, (D,), dt), ("ln_b", ln_b, (D,), dt),
            ("q_w", q_w, (E, D), dt), ("k_w", k_w, (E, D), dt),
            ("v_w", v_w, (E, D), dt), ("out_w", out_w, (D, E), dt),
            ("bias_u", bias_u, (H, Dh), dt), ("bias_v", bias_v, (H, Dh), dt),
            ("pp", pp, (H, Dh, s_buf + 1), torch.float32),
            ("mask", mask, (B, s_buf + 1), dt)):
        _check(name, t, shape, want, dev)
    if not all(t.is_contiguous() for t in caches):
        raise ValueError("t1_attention_block: K/V buffers must be contiguous")
    elem = 1 if quant else caches[0].element_size()
    check_shape(Dh, elem, s_buf)
    ins = [t.contiguous() for t in (x, ln_w, ln_b, q_w, k_w, v_w, out_w,
                                    bias_u, bias_v, pp, mask)]
    codes = (k_buf.q, v_buf.q) if quant else caches
    if any(t.data_ptr() % 16 for t in (*ins, *codes)):
        raise ValueError("t1_attention_block: operands must be 16-byte "
                         "aligned (bulk copies and TMA)")
    sms = sm_count(dev)
    if dt == torch.bfloat16:
        qkv_plan, out_plan = block_gemm_plans(B, D, sms, E)
        plan = (qkv_plan.nt, qkv_plan.splits, qkv_plan.steps_per,
                out_plan.nt, 1, out_plan.steps)
        f32 = (None, None, None)
    else:  # f32: the FFMA body; LN statistics, the out GEMM's split-K
        qkv_plan, out_plan = block_f32_plans(B, D, s_buf, Dh, elem, sms, E)
        plan = (qkv_plan.bm, qkv_plan.splits, qkv_plan.steps_per,
                out_plan.bm, out_plan.splits, out_plan.steps_per)
        f32 = (torch.empty((B, 2), dtype=torch.float32, device=dev),
               *f32_scratch(out_plan, dev))
    attn = attn_group(B, H, s_buf, Dh, elem, plan[1], sms)
    out = torch.empty((B, D), dtype=dt, device=dev)
    k_new = torch.empty((B, H, Dh), dtype=dt, device=dev)
    v_new = torch.empty((B, H, Dh), dtype=dt, device=dev)
    qkv = torch.empty((plan[1], B, 3 * E), dtype=torch.float32, device=dev)
    ctx = torch.empty((B, E), dtype=dt, device=dev)
    symbol = ("t1_attention_block_i8_" if quant
              else "t1_attention_block_") + _SUFFIX[dt]
    kernels.T1_ATTENTION_BLOCK.launch(
        symbol, *(t.data_ptr() for t in ins), *(t.data_ptr() for t in caches),
        *(t.data_ptr() for t in (out, k_new, v_new, qkv, ctx)),
        *(_ptr(t) for t in f32),
        B, H, s_buf, Dh, D, int(residual), eps, 1.0 / math.sqrt(Dh), *plan,
        attn.per_block, attn.groups, attn.stages)
    return out, k_new, v_new
