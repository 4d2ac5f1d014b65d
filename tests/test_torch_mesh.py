"""The port's device mesh (nemotron_tpu_torch/parallel/mesh.py) against the
JAX package's, at tiny size on the CPU: meshes of ["cpu"] * n in the port,
the JAX package's virtual CPU devices (tests/conftest.py) there.

- param_shardings splits the same axes as the JAX package's specs, field
  by field, dense and quantized;
- the sharded stream_step at dp x tp = 8x1, 4x2 and 2x2 against JAX's
  sharded stream_step (as tests/test_parallel.py:24-64): the gated step
  with every slot active, and the phased fast path, over two chunks;
  tokens equal, every float leaf within 2e-5 after the first chunk and 5e-5
  after the second (JAX's own test's tolerances; the tp partial products
  are summed in another order), integer leaves equal;
- under tp = 2, Q8_0 and Q4_0 weights and int8 K/V caches: tokens equal,
  int8 codes within +-1 (a value on a rounding boundary may round either
  way), every other leaf within the same tolerances, except that with int8
  K/V the second chunk reads a code that may have rounded the other way:
  one step of its frame's scale (amax / 127) moves that chunk's attention,
  and the leaves it writes that are not K/V (the conv cache, 3.4e-4 here)
  are held within INT8_FLIP_ATOL;
- tp_slice keeps the values of every quantized weight (the Q4_0 half-split
  nibbles re-packed per input slice);
- kernel B3's plain version with H_l * Dh != D and the residual off,
  summed over the tp shards plus the residual, equals the unsharded one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg, tiny_hparams, tiny_model

from nemotron_tpu.models.asr import stream_step as j_stream_step
from nemotron_tpu.parallel import mesh as jmesh
from nemotron_tpu.params import quantize_encoder_layers as j_quantize
from nemotron_tpu.streaming.state import init_stream_state as j_init
from nemotron_tpu_torch.api import ASRModel
from nemotron_tpu_torch.ops.attn_block import t1_attention_block_ref
from nemotron_tpu_torch.ops.kvquant import quantize_kv
from nemotron_tpu_torch.ops.quant import (QuantizedTensor, dequantize,
                                          dequantize_q4, quantize_q4,
                                          quantize_q8)
from nemotron_tpu_torch.parallel import mesh as tmesh
from nemotron_tpu_torch.params import TP_SPLIT, params_from_numpy, tp_slice
from nemotron_tpu_torch.streaming.state import MeshState, state_leaves

torch.set_num_threads(1)

B = 8
INT8_FLIP_ATOL = 1e-3
# a width at which the tp = 2 slices keep whole Q8_0 / Q4_0 blocks
WIDE = dict(d_model=128, n_heads=4, d_head=32, d_ff=256)


def cpu_devices(n):
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"need {n} cpu devices, have {len(devs)}")
    return devs[:n]


def j_leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def t_leaves(state):
    out = []
    for x in state_leaves(state):
        x = x.detach().cpu()
        out.append(x.float().numpy() if x.dtype == torch.bfloat16
                   else x.numpy())
    return out


def assert_states_close(jstate, tstate, atol, other_atol=None):
    """Leaf by leaf: int8 codes within +-1, integers equal, floats within
    atol (the leaves past the K/V caches within other_atol, where given)."""
    js, ts = j_leaves(jstate), t_leaves(tstate)
    assert len(js) == len(ts)
    n_kv = 4 if js[0].dtype == np.int8 else 2
    for i, (j, t) in enumerate(zip(js, ts)):
        if i >= n_kv and other_atol is not None:
            atol = other_atol
        assert j.shape == t.shape, (i, j.shape, t.shape)
        if j.dtype == np.int8:  # int8 K/V codes
            assert np.abs(j.astype(np.int32) - t.astype(np.int32)).max() <= 1
        elif np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, atol=atol, rtol=1e-5,
                                       err_msg=f"leaf {i}")


def run_both(n_dp, n_tp, gated, quant=None, kv_int8=False, monkeypatch=None,
             **hp_kw):
    """Two chunks through JAX's sharded stream_step and the port's."""
    hp, jparams = tiny_model(seed=0, **hp_kw)
    if quant:
        jparams = j_quantize(jparams, bits=quant)
    cfg = tiny_cfg(hp)
    rng = np.random.default_rng(1)
    mels = [rng.standard_normal((B, cfg.chunk_mel_frames, hp.n_mels)
                                ).astype(np.float32) for _ in range(2)]
    n_valid = np.full((B,), cfg.valid_out_len, np.int32)
    active = np.ones((B,), bool)

    if kv_int8:
        monkeypatch.setenv("NEMOTRON_TPU_KV_INT8", "1")
    jm = jmesh.make_mesh(n_dp, n_tp, devices=cpu_devices(n_dp * n_tp))
    p_sh, s_sh = jmesh.place(jparams, j_init(B, hp, cfg), jm)
    step = jax.jit(lambda p, s, m, nv, a, phase: j_stream_step(
        p, s, m, nv, a, hp=hp, cfg=cfg, phase=phase), static_argnums=5)

    model = ASRModel(hp, params_from_numpy(jparams, device="cpu"), ["a"],
                     device="cpu", kv_int8=kv_int8)
    model.shard(tmesh.make_mesh(n_dp, n_tp, devices=["cpu"] * (n_dp * n_tp)))
    tstate = model.init_stream_state(B, model.cache_config(0))
    assert isinstance(tstate, MeshState) and len(tstate.shards) == n_dp
    for i, mel in enumerate(mels):
        phase = 0 if gated else i
        m_s, nv_s, a_s = jmesh.shard_inputs(jm, jnp.asarray(mel),
                                            jnp.asarray(n_valid),
                                            jnp.asarray(active))
        s_sh, jtok = step(p_sh, s_sh, m_s, nv_s, a_s if gated else None,
                          phase)
        tstate, ttok = model.stream_step(
            model.cache_config(0), tstate, model.put_batch(mel),
            model.put_batch(n_valid),
            model.put_batch(active) if gated else None, phase=phase)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        assert_states_close(s_sh, tstate, 2e-5 if i == 0 else 5e-5,
                            INT8_FLIP_ATOL if kv_int8 and i else None)
    return np.asarray(jtok)


def test_param_shardings_split_the_axes_jax_splits():
    hp, jparams = tiny_model(seed=0, **WIDE)
    for bits in (None, 8, 4):
        jp = j_quantize(jparams, bits=bits) if bits else jparams
        tp = params_from_numpy(jp, device="cpu")
        jm = jmesh.make_mesh(2, 2, devices=cpu_devices(4))
        jspec = jmesh.param_shardings(jp, jm)
        tspec = tmesh.param_shardings(
            tp, tmesh.make_mesh(2, 2, devices=["cpu"] * 4))

        def walk(j, t, path):
            if t is None:
                assert j is None, path
            elif dataclasses.is_dataclass(t):
                for f in dataclasses.fields(t):
                    walk(getattr(j, f.name), getattr(t, f.name),
                         f"{path}.{f.name}")
            else:  # a quantized field: one spec per leaf in JAX
                for leaf in jax.tree.leaves(j):
                    assert tuple(leaf.spec) == t, path

        walk(jspec, tspec, "params")
    assert set(TP_SPLIT) == {n for n, s in dataclasses.asdict(
        tspec.layers).items() if s}


@pytest.mark.parametrize("n_dp,n_tp", [(8, 1), (4, 2), (2, 2)])
def test_sharded_gated_step_matches_jax(n_dp, n_tp):
    run_both(n_dp, n_tp, gated=True)


@pytest.mark.parametrize("n_dp,n_tp", [(8, 1), (4, 2), (2, 2)])
def test_sharded_fast_path_matches_jax(n_dp, n_tp):
    run_both(n_dp, n_tp, gated=False)


@pytest.mark.parametrize("case", ["q8", "q4", "kv_int8"])
def test_tp2_quantized_and_int8_kv_match_jax(case, monkeypatch):
    tok = run_both(2, 2, gated=False, monkeypatch=monkeypatch,
                   quant={"q8": 8, "q4": 4}.get(case),
                   kv_int8=case == "kv_int8", **WIDE)
    assert (tok >= 0).any()  # the chunks emitted tokens


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("axis", [1, 2])
def test_tp_slice_keeps_quantized_values(bits, axis):
    rng = np.random.default_rng(bits + axis)
    dense = rng.standard_normal((2, 64, 256)).astype(np.float32)
    w = quantize_q8(dense) if bits == 8 else quantize_q4(dense)
    deq = dequantize if bits == 8 else dequantize_q4
    full = deq(w)
    n = 2
    for t in range(n):
        part = tp_slice(w, axis, n, t)
        assert isinstance(part, type(w))
        step = full.shape[axis] // n
        want = full.narrow(axis, t * step, step)
        torch.testing.assert_close(deq(part), want, rtol=0, atol=0)
    if bits == 8:  # a slice that cuts a 32-column block is refused
        with pytest.raises(ValueError, match="blocks"):
            tp_slice(QuantizedTensor(w.w_i8[..., :96].contiguous(),
                                     w.scales[..., :3].contiguous()),
                     2, 2, 0)


@pytest.mark.parametrize("n_tp,int8", [(2, False), (4, False), (2, True)])
def test_attn_block_ref_summed_over_tp_shards(n_tp, int8):
    """B3's plain version at H_l = H / n_tp heads (H_l * Dh != D), residual
    off, summed over the shards plus the residual, against the unsharded
    block."""
    rng = np.random.default_rng(n_tp + 10 * int8)
    Bn, H, Dh, S = 3, 8, 16, 12
    D = H * Dh

    def r(*s, sc=1.0):
        return torch.tensor((rng.standard_normal(s) * sc).astype(np.float32))

    x, ln_w, ln_b = r(Bn, D), 1 + r(D, sc=0.1), r(D, sc=0.1)
    wq, wk, wv, wo = (r(D, D, sc=D ** -0.5) for _ in range(4))
    bu, bv, pp = r(H, Dh, sc=0.1), r(H, Dh, sc=0.1), r(H, Dh, S + 1)
    mask = torch.zeros(Bn, S + 1)
    mask[1, :4] = -1e9
    kb, vb = r(Bn, H, S, Dh), r(Bn, H, S, Dh)
    if int8:
        kb, vb = quantize_kv(kb), quantize_kv(vb)
    want, kn, vn = t1_attention_block_ref(x, ln_w, ln_b, wq, wk, wv, wo, bu,
                                          bv, pp, mask, kb, vb, H, Dh)
    hl = H // n_tp
    parts, ks = [], []
    for t in range(n_tp):
        rows = slice(t * hl * Dh, (t + 1) * hl * Dh)
        heads = slice(t * hl, (t + 1) * hl)

        def cut(buf):
            if int8:
                return type(buf)(buf.q[:, heads].contiguous(),
                                 buf.s[:, heads].contiguous())
            return buf[:, heads].contiguous()

        out, k_t, _ = t1_attention_block_ref(
            x, ln_w, ln_b, wq[rows], wk[rows], wv[rows], wo[:, rows],
            bu[heads], bv[heads], pp[heads], mask, cut(kb), cut(vb), hl, Dh,
            residual=False)
        parts.append(out)
        ks.append(k_t)
    got = x + sum(parts[1:], parts[0])
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(torch.cat(ks, dim=1), kn, atol=1e-6,
                               rtol=1e-6)


def test_mesh_refusals():
    hp = tiny_hparams()
    with pytest.raises(ValueError, match="needs 4 devices"):
        tmesh.make_mesh(2, 2, devices=["cpu"] * 3)
    model = ASRModel.random(hp, seed=0, device="cpu").shard(
        tmesh.make_mesh(4, 1, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="divisible by the mesh's dp=4"):
        model.init_stream_state(6, model.cache_config(0))
    with pytest.raises(ValueError, match="tp=3"):
        ASRModel.random(hp, seed=0, device="cpu").shard(
            tmesh.make_mesh(1, 3, devices=["cpu"] * 3))


def _ticks(model, n=3):
    """n all-active fused ticks at right context 0 over B streams of random
    PCM from a fresh state: (state, tokens)."""
    cfg = model.cache_config(0)
    rng = np.random.default_rng(5)
    state = model.init_stream_state(B, cfg)
    toks = []
    for phase in range(n):
        audio = (rng.standard_normal((B, cfg.shift_samples)) * 3000
                 ).astype(np.int16)
        packed = model.pack_tick_inputs(
            audio, np.full(B, cfg.valid_out_len), np.zeros(B), None)
        state, tok = model.fused_tick_packed(
            cfg, state, model.put_batch(packed), True, phase=phase)
        toks.append(tok)
    return state, torch.cat(toks, dim=1)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_attn_block_over_tp_matches_one_device(kv_int8):
    """The fused attention block (kernel B3's plain version here) as each tp
    shard runs it, H_l = H / 2 heads with the residual left out and added
    once after the sum, through the fused tick on a 2x2 mesh: tokens equal
    to one device's, leaves within 2e-5 (int8 codes within +-1)."""
    hp = tiny_hparams(**WIDE)

    def build():
        return ASRModel.random(hp, seed=2, device="cpu", attn_block=True,
                               kv_int8=kv_int8)

    s1, t1 = _ticks(build())
    mesh_model = build().shard(tmesh.make_mesh(2, 2, devices=["cpu"] * 4))
    s2, t2 = _ticks(mesh_model)
    assert torch.equal(t1, t2) and bool((t1 >= 0).any())
    for a, b in zip(state_leaves(s1), state_leaves(s2)):
        if a.dtype == torch.int8:
            assert int((a.int() - b.int()).abs().max()) <= 1
        else:
            torch.testing.assert_close(b, a, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("n_tp", [2, 4, 8])
def test_plans_cover_every_tp_shape(n_tp):
    """The bf16 and f32 plans of B4 / B5 (ops/quant.py; in bf16 the M <=
    256 form or, from gemm_plan's crossover, the large-M form) and of B3's
    projections (ops/attn_block.py) at the encoder's (N, K) cut by tp, at
    a tick's rows at right contexts 0 to 13 and an offline segment's, on
    the H100's 132 SMs: each plan covers K once with no empty split."""
    from nemotron_tpu_torch.ops.attn_block import (block_f32_plans,
                                                   block_gemm_plans)
    from nemotron_tpu_torch.ops.quant import (GEMM_M_TILES, GEMM_STEP,
                                              LARGE_ROWS, F32_STEP,
                                              LargePlan, f32_plan,
                                              gemm_plan)

    def covers(splits, steps_per, steps):
        assert splits >= 1 and steps_per >= 1
        assert (splits - 1) * steps_per < steps <= splits * steps_per

    d, d_ff = 1024, 4096
    shapes = [(d // n_tp, d), (d_ff // n_tp, d), (d, d_ff // n_tp),
              (d, d // n_tp)]
    for m in (1, 32, 141, 256, 512, 1792, 3584, 16384):
        for n, k in shapes:
            for bits in (8, 4):
                p = gemm_plan(m, n, k, bits, 132)
                if isinstance(p, LargePlan):  # one split over all of K
                    assert p.tiles_m * LARGE_ROWS >= m
                    assert p.tiles_n * p.bn >= n
                    covers(1, p.steps, -(-k // GEMM_STEP))
                    continue
                assert p.m_tile in GEMM_M_TILES and p.m_tile * p.tiles_m >= m
                covers(p.splits, p.steps_per,
                       -(-(k if bits == 8 else k // 2) // GEMM_STEP))
            f = f32_plan(m, n, k, 132)
            covers(f.splits, f.steps_per, -(-k // F32_STEP))
    e = d // n_tp
    for b in (1, 32, 256):
        qkv, out = block_gemm_plans(b, d, 132, e)
        covers(qkv.splits, qkv.steps_per, qkv.steps)
        assert out.splits == 1 and out.steps == -(-e // GEMM_STEP)
        for elem in (1, 2, 4):
            fq, fo = block_f32_plans(b, d, 78, 128, elem, 132, e)
            covers(fq.splits, fq.steps_per, -(-d // F32_STEP))
            covers(fo.splits, fo.steps_per, -(-e // F32_STEP))


def test_state_shardings_and_shard_inputs_split_dp_as_jax():
    """state_shardings: the stream state split over 'dp' on its batch axis,
    leaf by leaf as the JAX package's specs; shard_inputs: each input's
    rows split over the dp shards in order."""
    hp, jparams = tiny_model(seed=0)
    cfg = tiny_cfg(hp)
    jm = jmesh.make_mesh(4, 1, devices=cpu_devices(4))
    want = [tuple(s.spec) for s in jax.tree.leaves(
        jmesh.state_shardings(j_init(B, hp, cfg), jm))]
    model = ASRModel(hp, params_from_numpy(jparams, device="cpu"), ["a"],
                     device="cpu")
    mesh = tmesh.make_mesh(4, 1, devices=["cpu"] * 4)
    specs = tmesh.state_shardings(
        model.init_stream_state(B, model.cache_config(0)), mesh)

    def fields(x):  # the specs in the dataclasses' field order
        if isinstance(x, tuple):
            return [x]
        return [s for f in dataclasses.fields(x)
                for s in fields(getattr(x, f.name))]

    assert fields(specs) == want
    mel = np.arange(B * 6, dtype=np.float32).reshape(B, 2, 3)
    parts = tmesh.shard_inputs(mesh, mel, np.arange(B), np.ones(B, bool))
    assert [p.parts[1].shape[0] for p in parts] == [2, 2, 2]
    np.testing.assert_array_equal(parts[0].parts[3].numpy(), mel[6:])
