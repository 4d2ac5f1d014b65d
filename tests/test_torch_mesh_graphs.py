"""A tp group's graphed calls on the CPU: a dp=2 x tp=2 mesh of ["cpu"] * 4
in the port (parallel/mesh.py), JAX's sharded model on its virtual CPU
devices (tests/conftest.py). On the card each of these calls is one CUDA
graph per JAX key and dp shard, its ranks on streams of their own
(params.TPGroup.each); here the same bodies run eagerly through the same
bookkeeping (graphs.py).

- No host sync: every body the graph cache runs for the mesh (the ticks,
  the four slot operations over HeadShards caches, stream_step, the two
  halves of fused_tick_profiled, the offline encoder and its decode
  blocks) runs, from its key's second call on, under
  test_torch_graphs.NoHostSync.
- Fixed storage against JAX: the schedule segments of
  tests/test_torch_graphs.py (a wrap, a k=4 backlog, a masked tick and its
  realign, a join) on both sharded models; tokens equal, leaves within
  1e-4 (as tests/test_torch_mesh.py holds the sharded step), and every
  state tensor, each HeadShards part included, keeps its data_ptr.
- The keys: the mesh's calls reach GraphCache.run under the keys a
  one-device model's reach, once per dp shard, each with its tp group's
  devices; the tick and slot keys equal JAX's `_fn_cache` keys after the
  same calls on JAX's sharded model.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from helpers import tiny_hparams
from test_torch_graphs import (HALF, NoHostSync, Pair, _body_calls,
                               _sync_model, carries, make_audio)
from test_torch_tick import assert_states_close

from nemotron_tpu.api import ASRModel as JaxModel
from nemotron_tpu.parallel import mesh as jmesh
from nemotron_tpu.streaming.state import reset_slots as j_reset_slots
from nemotron_tpu_torch.api import ASRModel as TorchModel
from nemotron_tpu_torch.graphs import GraphCache
from nemotron_tpu_torch.ops.kvquant import HeadShards
from nemotron_tpu_torch.parallel.mesh import make_mesh
from nemotron_tpu_torch.params import TPGroup
from nemotron_tpu_torch.streaming.engine import PRIME_SAMPLES
from nemotron_tpu_torch.streaming.state import (MeshState, state_from_leaves,
                                                state_leaves, state_tensors)
from nemotron_tpu_torch.tools.graph_turns import compare, run_schedule, twin

torch.set_num_threads(1)

B = 4  # two slots per dp shard


def mesh22():
    return make_mesh(2, 2, devices=["cpu"] * 4)


def jax_mesh22():
    devs = jax.devices("cpu")
    if len(devs) < 4:
        pytest.skip(f"need 4 cpu devices, have {len(devs)}")
    return jmesh.make_mesh(2, 2, devices=devs[:4])


class Checked:
    """Wraps a model's GraphCache.run: from a key's second call on (its
    capture and replays on the card) the body runs under NoHostSync; every
    call's (key, shard, devices) is recorded, and the ops each key kind
    ran under the mode are counted."""

    def __init__(self, model):
        self.calls, self.ops = [], {}
        cache, run = model.graphs, model.graphs.run

        def checked(key, shard, device, body, state, inputs, **kw):
            self.calls.append((key, shard, tuple(kw.get("devices", ()))))
            if not cache.entries.get((key, shard)):
                return run(key, shard, device, body, state, inputs, **kw)

            def under(s, *r):
                with NoHostSync() as mode:
                    out = body(s, *r)
                self.ops[key[0]] = self.ops.get(key[0], 0) + mode.ops
                return out
            return run(key, shard, device, under, state, inputs, **kw)

        model.graphs.run = checked


@pytest.mark.parametrize("form", ["f32", "int8-kv", "block"])
def test_tp_tick_and_slot_bodies_read_nothing_back(form):
    """run_schedule's two first passes (every tick key of R=0, the prime,
    the reset, the wrap's compaction, the realign) on the 2x2 mesh."""
    tm = _sync_model(form).shard(mesh22())
    seen = Checked(tm)
    run_schedule(tm, B, 0, passes=2)
    assert {k for k, n in seen.ops.items() if n > 0} == {
        "tick_packed", "prime", "reset", "compact", "realign"}
    assert seen.ops["tick_packed"] > 1000


@pytest.mark.parametrize("body", ["masked", "legacy", "stream_step_all",
                                  "stream_step_gated", "profiled_all",
                                  "profiled_gated"])
def test_tp_step_bodies_read_nothing_back(body):
    tm = _sync_model("f32").shard(mesh22())
    call = _body_calls(tm, body, 0)
    call()  # the warm-up (it fills the constants' caches)
    with NoHostSync() as mode:
        call()
    assert mode.ops > 100


def test_tp_masked_slot_ops_read_nothing_back():
    """The masked and the mid-cycle compaction and a realign backwards,
    over the int8 HeadShards caches, under the mask of some slots."""
    tm = _sync_model("int8-kv").shard(mesh22())
    cfg = tm.cache_config(0)
    state = tm.init_stream_state(B, cfg)
    assert isinstance(state.shards[0].k_cache, HeadShards)
    calls = (lambda s: tm.compact_state(cfg, s, mask=HALF),
             lambda s: tm.compact_state(cfg, s, phase=3, mask=HALF),
             lambda s: tm.realign_state(cfg, s, -2, HALF))
    for call in calls:
        state = call(state)  # the warm-up
        with NoHostSync() as mode:
            assert call(state) is state
        assert mode.ops > 4


def test_tp_offline_bodies_read_nothing_back():
    """The offline encoder's body and the decode blocks, on dp shard 0's tp
    group, from their second call on; the same texts as one device."""
    single = TorchModel.random(tiny_hparams(), seed=1, device="cpu")
    tm = twin(single, graphs=True).shard(mesh22())
    seen = Checked(tm)
    audios = [make_audio(9000, 4, b=1)[0], make_audio(5000, 5, b=1)[0]]
    for _ in range(2):
        texts = tm.transcribe_audios(audios)
    assert texts == single.transcribe_audios(audios)
    assert seen.ops.get("batch", 0) > 100 and seen.ops.get("batch_decode")
    group = tm.groups[0].devices
    assert {c for c in seen.calls if c[0][0] == "batch"} == {
        (("batch", tm.offline_stats[0]["mel_frames"], 2), 0, tuple(group))}


class MeshPair(Pair):
    """test_torch_graphs.Pair on both packages' 2x2 meshes: JAX's sharded
    model and the port's, the join through the API's graphed reset."""

    def __init__(self, mode=0, phase=0, n_chunks=6, seed=3):
        hp = tiny_hparams()
        self.jm = JaxModel.random(hp, seed=1).shard(jax_mesh22())
        self.tm = TorchModel.random(hp, seed=1, device="cpu").shard(mesh22())
        self.seen = Checked(self.tm)
        self.cfg = self.tm.cache_config(mode)
        self.audio = make_audio(PRIME_SAMPLES + n_chunks
                                * self.cfg.shift_samples, seed)
        self.pos = np.full(B, PRIME_SAMPLES)
        self.js = self.jm.init_stream_state(B, self.cfg)
        self.ts = self.tm.init_stream_state(B, self.cfg)
        assert isinstance(self.ts, MeshState)
        self.ptrs = [t.data_ptr() for t in state_tensors(self.ts)]
        self.prime(np.ones(B, bool), *carries(self.audio))
        self.phase = phase
        self.slot_phase = np.full(B, phase)

    def prime(self, mask, tails, lasts):
        self.js = self.jm.prime_frontend(self.js, mask, tails, lasts)
        self._same(self.tm.prime_frontend(self.ts, mask, tails, lasts,
                                          cfg=self.cfg))

    def join(self, slot, seed):
        mask = np.zeros(B, bool)
        mask[slot] = True
        self.js = j_reset_slots(self.js, mask, self.tm.hp)
        self._same(self.tm.reset_state(self.ts, mask, cfg=self.cfg))
        lo = self.pos[slot] - PRIME_SAMPLES
        self.audio[slot, lo:] = make_audio(self.audio.shape[1] - lo, seed,
                                           b=1)[0]
        self.prime(mask, *carries(self.audio[:, lo:]))
        self.slot_phase[slot] = self.phase

    def check(self, where):
        logical = state_from_leaves(state_leaves(self.ts), self.tm.kv_int8)
        assert_states_close(self.js, logical, where)
        assert [t.data_ptr() for t in state_tensors(self.ts)] == self.ptrs, \
            where


def _norm(keys):
    """Keys with each CacheConfig as its field values; the port's prime
    key carries its group's cfg beyond JAX's ("prime",), and JAX has no
    reset key."""
    out = set()
    for key in keys:
        if key[0] in ("prime", "reset"):
            key = key[:1]
        out.add(tuple(tuple(dataclasses.asdict(x).items())
                      if dataclasses.is_dataclass(x) else x for x in key))
    return out - {("reset",)}


def _wraps(run):
    """R=13 (two phases): two ticks, through the wrap."""
    for _ in range(2):
        run.tick()
    assert run.phase == 0


def _backlog(run):
    run.tick(k=4)  # from phase 4: its wrap inside
    run.tick()


def _masked(run):
    run.tick()
    run.tick(active=HALF)  # slots 1 and 3 paused, realigned on resume
    run.tick()


def _join(run):
    run.tick()
    run.join(2, seed=9)  # slot 2 of dp shard 1
    run.tick()


SEGMENTS = {"wraps": (13, 0, _wraps), "backlog": (0, 4, _backlog),
            "masked": (0, 0, _masked), "join": (0, 0, _join)}


@pytest.mark.parametrize("name", list(SEGMENTS))
def test_tp_fixed_storage_ticks_match_jax(name):
    mode, phase, seg = SEGMENTS[name]
    run = MeshPair(mode=mode, phase=phase)
    seg(run)
    run.check(f"after {name}")
    # every call went to the graph cache with its group's devices
    groups = {d: tuple(g.devices) for d, g in enumerate(run.tm.groups)}
    assert run.seen.calls and all(devs == groups[shard]
                                  for _, shard, devs in run.seen.calls)
    # the keys match JAX's sharded model's after the same calls
    assert _norm(run.tm.graphs.keys()) == _norm(run.jm._fn_cache)
    # one entry per dp shard for every key
    assert {s for _, s in run.tm.graphs.entries} == {0, 1}
    assert len(run.tm.graphs.entries) == 2 * len(run.tm.graphs.keys())


def test_tp_keys_equal_one_device_keys():
    """The same schedule on one device and on the 2x2 mesh reaches the
    same keys, the mesh's once per dp shard with equal calls; tokens
    equal and leaves within 1e-4."""
    single = TorchModel.random(tiny_hparams(), seed=1, device="cpu")
    mesh = twin(single, graphs=True).shard(mesh22())
    tok_1, st_1 = run_schedule(single, B, 0, passes=1)
    tok_m, st_m = run_schedule(mesh, B, 0, passes=1)
    assert all(np.array_equal(a, b) for a, b in zip(tok_1, tok_m))
    assert compare(st_1, st_m)["max_abs"] <= 1e-4
    assert mesh.graphs.keys() == single.graphs.keys()
    for (key, shard), e in mesh.graphs.entries.items():
        assert e.calls == single.graphs.entries[key, 0].calls, (key, shard)
        assert e.devices == tuple(mesh.groups[shard].devices)
    assert single.graphs.entries[next(iter(single.graphs.keys())), 0] \
        .devices == ()


def test_each_runs_the_ranks_in_order_on_the_cpu():
    """TPGroup.each on CPU devices: no streams, fn(t) in rank order; the
    graph cache runs a CPU body eagerly whatever its devices."""
    group = TPGroup([torch.device("cpu")] * 2, [None, None])
    assert group.streams is None
    assert group.each(lambda t: t * 10) == [0, 10]
    cache = GraphCache()
    out = cache.run(("k",), 0, torch.device("cpu"),
                    lambda s, x: (x + 1,), (), (torch.zeros(2),),
                    devices=group.devices)
    assert torch.equal(out[0], torch.ones(2))
    assert cache.stats()["captures"] == 0 and cache.stats()["calls"] == 1



@pytest.mark.parametrize("spans, want", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 15)], 15),        # two rank streams overlapping
    ([(0, 10), (2, 4)], 10),         # one span inside another
    ([(20, 30), (0, 10), (10, 12)], 22),  # out of order, touching
    ([(0, 10), (3, 6), (8, 20), (25, 30)], 25),
])
def test_union_ns_counts_overlapping_spans_once(spans, want):
    """tools/turns.union_ns, the device busy time that chip_smoke.py's mesh
    rows divide by the host time: a span that overlaps another (a tp rank's
    kernel beside another rank's on one card) counts once, so the busy
    time never exceeds the stretch the spans cover."""
    from nemotron_tpu_torch.tools.turns import union_ns

    assert union_ns(spans) == want
    if spans:
        lo = min(s for s, _ in spans)
        hi = max(e for _, e in spans)
        assert union_ns(spans) <= min(hi - lo, sum(e - s for s, e in spans))
