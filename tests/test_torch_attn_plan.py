"""The pure Python plans of kernels B1 and B3 and B1's shape rule.

ops/attn_kernel.py:attn_plan cuts B1's (stream, head) pairs into blocks
(a ring of pairs per block, or a cluster that splits one pair's slots);
ops/attn_block.py:block_gemm_plans cuts B3's bf16 projections into batch
tiles, weight-row tiles and K splits, block_f32_plans its f32 ones (the
FFMA body's plan, ops/quant.py:f32_plan), attn_group B3's attention launch
into (head, stream group) blocks. Each must cover every pair, slot, stream and
weight row once, keep every split non-empty, fit a block's shared memory
and stay within one wave of the SMs. check_shape says which cache rows the
bulk-copy body takes. The split-K order of the projections is emulated
on the CPU against the plain version and the JAX package's Pallas block.
"""

import math

import numpy as np
import pytest
import torch

from helpers import tiny_cfg, tiny_hparams
from nemotron_tpu.ops.attn_block_pallas import t1_attention_block as j_block
from nemotron_tpu_torch.config import CacheConfig, Hparams
from nemotron_tpu_torch.ops import attn_block as ab
from nemotron_tpu_torch.ops import attn_kernel as ak
from nemotron_tpu_torch.ops import quant as tq

SMS = 132  # the H100's SM count
BATCHES = (1, 7, 8, 32, 141, 256)
ELEMS = {"f32": 4, "bf16": 2, "int8": 1}


def _geometries():
    """(S_buf, d_head, n_heads) of the full-width model and the tiny one."""
    full, tiny = Hparams(), tiny_hparams()
    return [(CacheConfig.for_mode(0, full).cache_buf_len(full), full.d_head,
             full.n_heads),
            (tiny_cfg(tiny).cache_buf_len(tiny), tiny.d_head, tiny.n_heads)]


GEOMETRIES = _geometries()


@pytest.mark.parametrize("geom", GEOMETRIES, ids=["full", "tiny"])
@pytest.mark.parametrize("kind", ELEMS)
@pytest.mark.parametrize("b", BATCHES)
def test_b1_plan_covers_every_pair_and_slot_once(b, kind, geom):
    s_buf, d_head, heads = geom
    pairs = b * heads
    act = 2 if kind == "bf16" else 4
    p = ak.attn_plan(pairs, s_buf, SMS)
    assert p.cluster in (1, 2, 4)
    assert p.blocks == pairs * p.cluster
    n = -(-s_buf // p.cluster)
    slots = np.zeros(s_buf, int)
    for r in range(p.cluster):
        lo, hi = r * n, min(s_buf, (r + 1) * n)
        assert hi > lo  # every block of a cluster keeps a slot
        slots[lo:hi] += 1
    assert (slots == 1).all()
    assert ak.b1_smem(n, d_head, ELEMS[kind], act) <= ak.SMEM_BLOCK
    if p.cluster > 1:  # clusters only where the pairs leave SMs idle
        assert pairs * p.cluster // 2 < SMS


def test_b1_plan_splits_slots_over_a_cluster_at_the_servers_batch():
    """At batch 8 (64 pairs for 132 SMs) each pair's slots go to a cluster;
    from 132 pairs up one block per pair."""
    s_buf, d_head, heads = GEOMETRIES[0]
    assert ak.attn_plan(8 * heads, s_buf, SMS).cluster == 4
    assert ak.attn_plan(32 * heads, s_buf, SMS).cluster == 1
    assert ak.attn_plan(256 * heads, s_buf, SMS).cluster == 1


@pytest.mark.parametrize("d", [64, 1024])
@pytest.mark.parametrize("m", BATCHES)
def test_block_gemm_plans_cover_every_row_and_stream_once(m, d):
    qkv, out = ab.block_gemm_plans(m, d, SMS)
    for plan, parts, ln in ((qkv, 3, True), (out, 1, False)):
        assert plan.nt in ab.GEMM_M_TILES
        assert plan.nt <= ab.QKV_MAX_TILE or not ln
        # streams: tiles of nt rows, the last one ragged
        assert plan.tiles_m * plan.nt >= m > (plan.tiles_m - 1) * plan.nt
        # weight rows: tiles of 128 within each of q, k, v (none straddles)
        per_part = plan.tiles_n // parts
        assert plan.tiles_n == parts * per_part
        rows = np.zeros((parts, d), int)
        for t in range(plan.tiles_n):
            lo = (t % per_part) * ab.GEMM_ROWS
            assert lo < d
            rows[t // per_part, lo:lo + ab.GEMM_ROWS] += 1
        assert (rows == 1).all()
        # K: splits of steps_per steps, none empty, every column once
        assert plan.steps == -(-d // ab.GEMM_STEP)
        cols = np.zeros(plan.steps, int)
        for z in range(plan.splits):
            lo, hi = z * plan.steps_per, min(plan.steps,
                                             (z + 1) * plan.steps_per)
            assert hi > lo
            cols[lo:hi] += 1
        assert (cols == 1).all()
        # the launcher's ring of at least two stages fits
        assert ab.dense_smem(ln, plan.nt, plan.steps, 2) <= ak.SMEM_BLOCK
        assert plan.blocks <= SMS
    assert out.splits == 1  # the residual goes into the one epilogue


@pytest.mark.parametrize("geom", GEOMETRIES, ids=["full", "tiny"])
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("m", [1, 17, 141, 256])
def test_block_f32_plans_cover_every_output_and_column_once(m, int8, geom):
    """B3's f32 projections: each plan's tiles cover every (stream, output)
    once and its splits every K column once; the QKV splits fit the
    attention launch, which adds them (attn_group raises where they do
    not); at full width a small batch splits K in both, as the card wants."""
    s_buf, d_head, heads = geom
    d = heads * d_head
    elem = 1 if int8 else 4
    qkv, out = ab.block_f32_plans(m, d, s_buf, d_head, elem, SMS)
    for plan, n in ((qkv, 3 * d), (out, d)):
        assert plan == tq.f32_plan(m, n, d, SMS, plan.splits
                                   if plan is qkv else None)
        assert plan.tiles_m * plan.bm >= m > (plan.tiles_m - 1) * plan.bm
        assert plan.tiles_n * tq.F32_ROWS >= n
        cols = plan.split_columns(d)
        assert all(len(c) for c in cols)
        np.testing.assert_array_equal(np.concatenate(cols), np.arange(d))
        assert plan.blocks <= max(SMS, plan.tiles)
    p = ab.attn_group(m, heads, s_buf, d_head, elem, qkv.splits, SMS)
    assert ab.attn_smem(s_buf, d_head, elem, p.stages, qkv.splits,
                        p.groups) <= ak.SMEM_BLOCK
    if d == 1024 and m <= 17:
        assert qkv.splits > 1 and out.splits > 1


@pytest.mark.parametrize("geom", GEOMETRIES, ids=["full", "tiny"])
@pytest.mark.parametrize("kind", ELEMS)
@pytest.mark.parametrize("b", BATCHES)
def test_b3_attention_groups_fit_one_wave(b, kind, geom):
    s_buf, d_head, heads = geom
    d = heads * d_head
    splits = (ab.block_gemm_plans(b, d, SMS)[0].splits if kind == "bf16"
              else ab.block_f32_plans(b, d, s_buf, d_head, ELEMS[kind],
                                      SMS)[0].splits)
    p = ab.attn_group(b, heads, s_buf, d_head, ELEMS[kind], splits, SMS)
    assert p.per_block >= 1 and p.stages in (1, 2)
    assert 1 <= p.groups <= min(p.per_block, ab.MAX_GROUPS)
    assert ab.attn_smem(s_buf, d_head, ELEMS[kind], p.stages, splits,
                        p.groups) <= ak.SMEM_BLOCK
    assert p.blocks(b, heads) <= p.per_sm * SMS  # one wave
    assert p.blocks(b, heads) * p.per_block >= b * heads


@pytest.mark.parametrize("plan, args", [
    (ak.attn_plan, (8 * 8, 78, SMS)),
    (ak.check_shape, (128, 2, 78)),
    (ab.block_gemm_plans, (256, 1024, SMS)),
    (ab.attn_group, (256, 8, 78, 128, 1, 1, SMS)),
    (ab.block_f32_plans, (256, 1024, 78, 128, 4, SMS)),
    (tq.f32_plan, (256, 4096, 1024, SMS)),
], ids=["attn_plan", "check_shape", "block_gemm_plans", "attn_group",
        "block_f32_plans", "f32_plan"])
def test_plans_are_computed_once_per_shape(plan, args):
    """The wrappers run on every call of the tick: each plan is worked out
    once per shape and then looked up."""
    plan.cache_clear()
    first = plan(*args)
    assert plan(*args) is first
    info = plan.cache_info()
    assert (info.misses, info.hits) == (1, 1)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=["full", "tiny"])
@pytest.mark.parametrize("kind", ELEMS)
def test_shape_rule_takes_every_shape_the_model_runs(kind, geom):
    s_buf, d_head, _ = geom
    ak.check_shape(d_head, ELEMS[kind], s_buf)


@pytest.mark.parametrize("d_head, elem, s_buf", [
    (8, 1, 78),     # an 8-byte int8 row: below the copy's 16-byte granule
    (24, 2, 78),    # 48 bytes: three 16-byte chunks, not a power of two
    (96, 4, 78),    # 384 bytes: 24 chunks
    (256, 2, 78),   # more columns than a block has threads
    (128, 4, 0),    # no slot
    (128, 4, 400),  # 400 f32 rows of K and V do not fit a block
    (48, 1, 78),    # 48 int8 bytes: not a compiled width
])
def test_shape_rule_refuses_what_the_bulk_copy_does_not_take(d_head, elem,
                                                             s_buf):
    with pytest.raises(ValueError):
        ak.check_shape(d_head, elem, s_buf)


@pytest.mark.parametrize("m", [7, 32])
def test_split_qkv_order_matches_plain_and_jax(m):
    """The QKV projection summed as the kernel's splits do (each split's
    columns in f32, the partials added in split order, q from those sums)
    gives the plain block's result within f32 rounding, and the JAX
    package's Pallas block (interpret mode) too."""
    rng = np.random.default_rng(m)
    H, Dh, S = 4, 16, 16
    D = H * Dh
    qkv, _ = ab.block_gemm_plans(m, 1024, SMS)
    assert qkv.splits > 1

    def f(*shape, sc=1.0):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    args = dict(x=f(m, D), ln_w=1 + f(D, sc=0.1), ln_b=f(D, sc=0.1),
                q_w=f(D, D, sc=D ** -0.5), k_w=f(D, D, sc=D ** -0.5),
                v_w=f(D, D, sc=D ** -0.5), out_w=f(D, D, sc=D ** -0.5),
                bias_u=f(H, Dh, sc=0.1), bias_v=f(H, Dh, sc=0.1),
                pp=f(H, Dh, S + 1, sc=0.5),
                mask=np.zeros((m, S + 1), np.float32),
                k_buf=f(m, H, S, Dh), v_buf=f(m, H, S, Dh))
    t = {k: torch.tensor(v) for k, v in args.items()}
    want = ab.t1_attention_block_ref(**t, n_heads=H, d_head=Dh)
    # the kernel's order: four splits over K = D, each 16 columns here
    xf = t["x"]
    mu = xf.mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt((xf - mu).square().mean(-1, keepdim=True)
                                + 1e-5) * t["ln_w"] + t["ln_b"]
    cols = np.array_split(np.arange(D), qkv.splits)
    parts = [y[:, c] @ torch.cat([t["q_w"], t["k_w"], t["v_w"]])[:, c].T
             for c in cols]
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    q, k, v = (acc[:, i * D:(i + 1) * D].view(m, H, Dh) for i in range(3))
    torch.testing.assert_close(k, want[1], atol=1e-5, rtol=0)
    torch.testing.assert_close(v, want[2], atol=1e-5, rtol=0)
    scale = 1.0 / math.sqrt(Dh)
    pos = torch.einsum("bhd,hds->bhs", q + t["bias_v"], t["pp"])
    pos[..., -1] += ((q + t["bias_u"]) * k).sum(-1)
    sc = torch.cat([torch.einsum("bhd,bhsd->bhs", q + t["bias_u"],
                                 t["k_buf"]), torch.zeros(m, H, 1)], -1)
    w = torch.softmax(sc * scale + pos * scale, -1)
    ctx = (torch.einsum("bhs,bhsd->bhd", w[..., :-1], t["v_buf"])
           + w[..., -1:] * v).reshape(m, D)
    out = xf + ctx @ t["out_w"].T
    torch.testing.assert_close(out, want[0], atol=1e-5, rtol=0)
    j_out = j_block(*(args[k] for k in ("x", "ln_w", "ln_b", "q_w", "k_w",
                                        "v_w", "out_w", "bias_u", "bias_v",
                                        "pp", "mask", "k_buf", "v_buf")),
                    n_heads=H, d_head=Dh, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out[0]), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("m", [1, 17])
def test_f32_split_order_matches_plain_and_jax(m):
    """Both f32 projections summed as the kernel's splits do (each split's
    columns in f32, the partials added in split order: QKV by the attention
    launch, out by the tile's last block before the residual) give the
    plain block's result within 1e-5 x max|y|, and the JAX package's Pallas
    block (interpret mode) too."""
    rng = np.random.default_rng(m + 100)
    H, Dh, S = 4, 64, 16
    D = H * Dh
    qkv_p, out_p = ab.block_f32_plans(m, D, S, Dh, 4, SMS)
    assert qkv_p.splits > 1 and out_p.splits > 1

    def f(*shape, sc=1.0):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    args = dict(x=f(m, D), ln_w=1 + f(D, sc=0.1), ln_b=f(D, sc=0.1),
                q_w=f(D, D, sc=D ** -0.5), k_w=f(D, D, sc=D ** -0.5),
                v_w=f(D, D, sc=D ** -0.5), out_w=f(D, D, sc=D ** -0.5),
                bias_u=f(H, Dh, sc=0.1), bias_v=f(H, Dh, sc=0.1),
                pp=f(H, Dh, S + 1, sc=0.5),
                mask=np.zeros((m, S + 1), np.float32),
                k_buf=f(m, H, S, Dh), v_buf=f(m, H, S, Dh))
    t = {k: torch.tensor(v) for k, v in args.items()}
    want = ab.t1_attention_block_ref(**t, n_heads=H, d_head=Dh)

    def split_sum(a, w, plan):
        acc = None
        for c in plan.split_columns(D):
            c = torch.from_numpy(c)
            part = a[:, c] @ w[:, c].T
            acc = part if acc is None else acc + part
        return acc

    xf = t["x"]
    mu = xf.mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt((xf - mu).square().mean(-1, keepdim=True)
                                + 1e-5) * t["ln_w"] + t["ln_b"]
    acc = split_sum(y, torch.cat([t["q_w"], t["k_w"], t["v_w"]]), qkv_p)
    q, k, v = (acc[:, i * D:(i + 1) * D].view(m, H, Dh) for i in range(3))
    for got, ref in ((k, want[1]), (v, want[2])):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))
    scale = 1.0 / math.sqrt(Dh)
    pos = torch.einsum("bhd,hds->bhs", q + t["bias_v"], t["pp"])
    pos[..., -1] += ((q + t["bias_u"]) * k).sum(-1)
    sc = torch.cat([torch.einsum("bhd,bhsd->bhs", q + t["bias_u"],
                                 t["k_buf"]), torch.zeros(m, H, 1)], -1)
    w = torch.softmax(sc * scale + pos * scale, -1)
    ctx = (torch.einsum("bhs,bhsd->bhd", w[..., :-1], t["v_buf"])
           + w[..., -1:] * v).reshape(m, D)
    out = xf + split_sum(ctx, t["out_w"], out_p)
    tol = 1e-5 * float(want[0].abs().max())
    torch.testing.assert_close(out, want[0], atol=tol, rtol=0)
    j_out = j_block(*(args[k] for k in ("x", "ln_w", "ln_b", "q_w", "k_w",
                                        "v_w", "out_w", "bias_u", "bias_v",
                                        "pp", "mask", "k_buf", "v_buf")),
                    n_heads=H, d_head=Dh, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out[0]),
                               atol=1e-4, rtol=0)
