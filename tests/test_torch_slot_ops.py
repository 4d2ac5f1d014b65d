"""The slot operations between ticks against the JAX package, on the CPU
(where kernel kv_rows takes its plain version; the kernel is held against
it on the card in tests/test_torch_gpu.py).

Bit for bit, from the same numpy-seeded state: the compaction at the wrap
and at every mid-cycle phase, the realign at every delta in
+-1..+-(n_phases - 1), the slot reset and the frontend prime, at right
contexts 0 / 1 / 6 / 13, with dense f32, bf16 and int8 QuantKV caches,
under a mask that is none (the compaction's unmasked form; an all-clear
mask for the others), some slots or all. The port runs them through its
API (ASRModel.compact_state, realign_state, reset_state, prime_frontend:
each a keyed graph body, run eagerly here), the JAX package through its
functions (models/encoder.compact_cache, realign_cache;
streaming/state.reset_slots, prime_frontend).

Then an engine under churn (joins into a slot another stream left,
pauses of 1-3 ticks resumed at deltas 1-3, wraps with paused slots, k > 1
backlogs) on the port and on the JAX engine: the same events. And no host
read is left in the cache functions or the reset and prime: none in their
source, none among the ops each API call dispatches (the NoHostSync mode
of tests/test_torch_graphs.py)."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from helpers import tiny_hparams
from test_torch_graphs import NoHostSync

from nemotron_tpu.api import ASRModel as JaxModel
from nemotron_tpu.config import CacheConfig as JaxCacheConfig
from nemotron_tpu.models import encoder as jenc
from nemotron_tpu.streaming import state as jstate
from nemotron_tpu.streaming.engine import BatchedEngine as JaxEngine
from nemotron_tpu_torch.api import ASRModel as TorchModel
from nemotron_tpu_torch.config import CacheConfig
from nemotron_tpu_torch.models import encoder as tenc
from nemotron_tpu_torch.streaming import state as tstate
from nemotron_tpu_torch.streaming.engine import BatchedEngine

torch.set_num_threads(1)

B = 4
MASKS = {"none": None, "some": np.array([True, False, False, True]),
         "all": np.ones(B, bool)}
DTYPES = ("f32", "bf16", "int8")


def _host(x) -> np.ndarray:
    """A leaf as numpy, bf16 as its bit pattern (uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _states(mode: int, dtype: str, monkeypatch, seed: int):
    """A port model and (port state, JAX state) with the same random
    leaves: every float leaf normal, int8 codes uniform, int leaves small."""
    hp = tiny_hparams()
    int8 = dtype == "int8"
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    model = TorchModel.random(hp, seed=1, dtype=tdt, device="cpu",
                              kv_int8=int8)
    cfg = model.cache_config(mode)
    ts = model.init_stream_state(B, cfg)
    if int8:
        monkeypatch.setenv("NEMOTRON_TPU_KV_INT8", "1")
    js = jstate.init_stream_state(
        B, hp, JaxCacheConfig.for_mode(mode, hp),
        dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    rng = np.random.default_rng(seed)
    jleaves, treedef = jax.tree.flatten(js)
    new = []
    for t, j in zip(tstate.state_leaves(ts), jleaves):
        if t.dtype == torch.int8:
            a = rng.integers(-127, 128, t.shape).astype(np.int8)
        elif t.dtype == torch.int32:
            a = rng.integers(0, 30, t.shape).astype(np.int32)
        else:
            a = rng.standard_normal(t.shape).astype(np.float32)
        src = torch.from_numpy(a)
        t.copy_(src.to(t.dtype))
        new.append(jnp.asarray(a).astype(j.dtype))
    return model, cfg, ts, jax.tree.unflatten(treedef, new)


def _same(ts, js, what: str) -> None:
    tl, jl = tstate.state_leaves(ts), jax.tree.leaves(js)
    assert len(tl) == len(jl)
    for i, (t, j) in enumerate(zip(tl, jl)):
        t, j = _host(t), _host(j)
        assert t.dtype == j.dtype and t.shape == j.shape, (what, i)
        np.testing.assert_array_equal(t, j, err_msg=f"{what}: leaf {i}")


def _replace_kv(js, k, v):
    return dataclasses.replace(js, k_cache=k, v_cache=v)


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", (0, 1, 6, 13))
def test_slot_ops_equal_jax(mode, dtype, mask, monkeypatch):
    model, cfg, ts, js = _states(mode, dtype, monkeypatch,
                                 seed=100 * mode + DTYPES.index(dtype))
    hp, n = model.hp, cfg.n_phases
    m = MASKS[mask]
    m_all = np.zeros(B, bool) if m is None else m  # ops that need a mask
    jm = jnp.asarray(m_all)
    # the compaction: at the wrap, then at each mid-cycle phase
    for phase in (None, *range(1, n)):
        ts = model.compact_state(cfg, ts, phase=phase, mask=m)
        js = _replace_kv(js, *jenc.compact_cache(
            cfg, hp, js.k_cache, js.v_cache, phase=phase,
            mask=None if m is None else jm))
        _same(ts, js, f"compact phase {phase}")
    for delta in (*range(1, n), *range(-1, -n, -1)):
        ts = model.realign_state(cfg, ts, delta, m_all)
        js = _replace_kv(js, *jenc.realign_cache(
            cfg, hp, js.k_cache, js.v_cache, delta, jm))
        _same(ts, js, f"realign delta {delta}")
    ts = model.reset_state(ts, m_all, cfg=cfg)
    js = jstate.reset_slots(js, jm, hp)
    _same(ts, js, "reset")
    rng = np.random.default_rng(7)
    tails = rng.standard_normal(ts.pp_tail.shape).astype(np.float32)
    lasts = rng.standard_normal((B,)).astype(np.float32)
    ts = model.prime_frontend(ts, m_all, tails, lasts, cfg=cfg)
    js = jstate.prime_frontend(js, jm, jnp.asarray(tails),
                               jnp.asarray(lasts))
    _same(ts, js, "prime")
    keys = model.graphs.keys()
    assert {("prime", cfg), ("reset", cfg), ("realign", cfg, 1),
            ("compact", cfg, n, m is not None)} <= keys


N_PHASES = 4  # deltas 1-3 at right context 0, one JAX compile per phase


def _audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = 0.5 * np.sin(2 * np.pi * (210 + 50 * seed) * t) \
        + 0.2 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


SHIFT = 1280
# per tick, the chunks each of six streams pushes: None before it starts,
# "end" when it ends; streams 4 and 5 join into slots that 0 and 2 left
CHURN = [(1, 1, 1, None, None, None), (1, 0, 1, None, None, None),
         (1, 0, 1, 1, None, None), (1, 0, 0, 1, None, None),
         (1, 1, 0, 1, None, None), (1, 1, 0, 0, None, None),
         (1, 1, 1, 0, None, None), ("end", 1, 1, 1, None, None),
         (None, 0, 1, 1, None, None), (None, 1, "end", 0, None, None),
         (None, 1, None, 1, None, None), (None, 0, None, 1, 1, None),
         (None, 1, None, 0, 1, None), (None, 1, None, 1, 1, 1),
         (None, 6, None, 6, 6, 6), (None, 1, None, 0, 1, 1),
         (None, 0, None, 1, 1, 0), (None, 1, None, 1, 0, 1)]


def drive_churn(engine):
    audios = [_audio(96 + 40 * SHIFT, 40 + i) for i in range(6)]
    sids, pos, events = [None] * 6, [0] * 6, []
    for step in CHURN:
        for i, n in enumerate(step):
            if n is None or (sids[i] is None and n == "end"):
                continue
            if sids[i] is None:
                sids[i] = engine.start_stream(0)
            if n == "end":
                engine.end_stream(sids[i])
                continue
            take = n * SHIFT + (96 if pos[i] == 0 and n else 0)
            engine.push_audio(sids[i], audios[i][pos[i]:pos[i] + take])
            pos[i] += take
        for _ in range(2):
            events.extend(engine.tick()[0])
    for i, sid in enumerate(sids):
        if CHURN[-1][i] is not None:
            engine.push_audio(sid, audios[i][pos[i]:pos[i] + 3 * SHIFT])
            engine.end_stream(sid)
    for _ in range(300):
        ev, more = engine.tick()
        events.extend(ev)
        if not more:
            return events
    raise AssertionError("engine did not go idle")


def test_churn_engine_equals_jax(monkeypatch):
    for cls in (JaxCacheConfig, CacheConfig):
        monkeypatch.setitem(cls._MODE_N_PHASES, 0, N_PHASES)
    want = drive_churn(JaxEngine(JaxModel.random(tiny_hparams(), seed=1),
                                 B))
    model = TorchModel.random(tiny_hparams(), seed=1, device="cpu")
    engine = BatchedEngine(model, B)
    got = drive_churn(engine)
    assert [e.kind for e in want].count("ended") == 6
    assert sum(bool(e.text) for e in want) >= 6
    assert [(e.stream_id, e.kind, e.text) for e in got] == \
        [(e.stream_id, e.kind, e.text) for e in want]
    cfg = engine.groups[0].cfg
    keys = model.graphs.keys()
    # the churn reached each kind of slot operation: joins (reset, prime),
    # resumes (realign), masked and unmasked wraps, a backlog tick
    assert {("prime", cfg), ("reset", cfg), ("compact", cfg, N_PHASES, True),
            ("compact", cfg, N_PHASES, False)} <= keys
    assert any(k[0] == "realign" for k in keys)
    assert any(k[0] == "tick_packed" and k[5] > 1 for k in keys)


def test_has_free_slot_equals_jax():
    """EngineGroup.has_free_slot over claims, a release and a queued drop
    (applied at the next tick's top), against the JAX engine group's."""
    from nemotron_tpu.streaming.engine import EngineGroup as JaxGroup
    from nemotron_tpu_torch.streaming.engine import EngineGroup

    jm = JaxModel.random(tiny_hparams(), seed=1)
    tm = TorchModel.random(tiny_hparams(), seed=1, device="cpu")
    groups = [JaxGroup(jm, jm.cache_config(0), 2),
              EngineGroup(tm, tm.cache_config(0), 2)]
    seen = []
    for step in ("claim", "claim", "release", "claim", "drop", "apply"):
        for g in groups:
            if step == "claim":
                g.claim(len(seen), 0)
            elif step == "release":
                g.release(0)
            elif step == "drop":
                g.drop(1, 1)
            else:
                g._apply_pending_drops()
        got = [g.has_free_slot() for g in groups]
        assert got[0] == got[1], (step, got)
        seen.append(got[1])
    assert seen == [True, False, True, False, False, True]


@pytest.mark.parametrize("fn", [tenc.compact_cache, tenc.realign_cache,
                                tstate.reset_slots, tstate.prime_frontend],
                         ids=lambda f: f.__name__)
def test_slot_ops_read_nothing_back(fn):
    """No row selection by torch.nonzero and no scalar read in the slot
    operations (a host sync, which a CUDA graph cannot hold), nor
    anywhere in the two modules."""
    src = inspect.getsource(fn)
    for word in ("nonzero", ".item(", ".tolist(", ".cpu(", "numpy("):
        assert word not in src, (fn.__name__, word)
    for mod in (tenc, tstate):
        assert "nonzero" not in inspect.getsource(mod), mod.__name__


def test_engine_groups_key_their_own_slot_graphs():
    """Two engine groups of one model (right contexts 0 and 6), streams
    joining each in turn: each group's prime and reset have keys of their
    own, ("prime", cfg) and ("reset", cfg) (a graph is bound to the
    state's storage, so one key for both groups would be captured again
    at every other join), and the engine's stats count every key of a
    group under that group."""
    from nemotron_tpu_torch.tools.graph_turns import join_in_turns

    model = TorchModel.random(tiny_hparams(), seed=1, device="cpu")
    engine = BatchedEngine(model, B)
    engine.prewarm(right_contexts=(0, 6))
    join_in_turns(engine, (0, 6), joins=2)
    cfgs = {rc: engine.groups[rc].cfg for rc in (0, 6)}
    keys = model.graphs.keys()
    assert {(k, c) for k in ("prime", "reset") for c in cfgs.values()} == \
        {k for k in keys if k[0] in ("prime", "reset")}
    stats = engine.stats()["groups"]
    for rc, cfg in cfgs.items():
        assert stats[rc]["graphs"]["keys"] == len(
            [k for k in keys if cfg in k]), rc
    calls = {k: e.calls for (k, _), e in model.graphs.entries.items()
             if k[0] == "reset"}
    assert calls == {("reset", c): 4 for c in cfgs.values()}


SLOT_CALLS = ("compact wrap", "compact masked", "compact mid-cycle",
              "realign", "reset", "prime")


@pytest.mark.parametrize("form", ("f32", "int8"))
@pytest.mark.parametrize("call", SLOT_CALLS)
def test_slot_op_dispatches_no_host_read(call, form):
    """Each slot operation's API call (its graph body and its uploads) a
    second time under NoHostSync: no scalar read, nonzero or copy to the
    host among its ops."""
    model = TorchModel.random(tiny_hparams(), seed=1, device="cpu",
                              kv_int8=form == "int8")
    cfg = model.cache_config(0)
    box = [model.init_stream_state(B, cfg)]
    m = MASKS["some"]
    tails = np.ones((B, box[0].pp_tail.shape[1]), np.float32)
    fns = {"compact wrap": lambda s: model.compact_state(cfg, s),
           "compact masked": lambda s: model.compact_state(cfg, s, mask=m),
           "compact mid-cycle": lambda s: model.compact_state(
               cfg, s, phase=3, mask=m),
           "realign": lambda s: model.realign_state(cfg, s, -2, m),
           "reset": lambda s: model.reset_state(s, m, cfg=cfg),
           "prime": lambda s: model.prime_frontend(
               s, m, tails, np.ones(B, np.float32), cfg=cfg)}
    box[0] = fns[call](box[0])  # the warm-up
    with NoHostSync() as mode:
        box[0] = fns[call](box[0])
    assert mode.ops > 2
