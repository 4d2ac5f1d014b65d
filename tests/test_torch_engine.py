"""The port's BatchedEngine on the CPU, ticked by hand: every stream's
transcript equals the direct tick loop over its audio (exact tokens) when
the engine takes the k=8 backlog path, and when streams join late, starve
mid-stream (masked ticks, realign on resume, masked wrap compaction) and
end on and off chunk boundaries. The checks take the model, so that
tests/test_torch_serve_int8.py runs them on the int8 configuration.

The readback FIFO holds dispatched steps only: streams that end on a chunk
boundary (no leftover frame, so no finalizing row) in a dispatching tick
never make that tick wait on its own step; their `ended` events come with
the next tick's collection, after their last text, and an idle tick
drains every step and end."""

import pytest
import torch

from test_torch_server import build_model, direct_transcript, make_audio

from nemotron_tpu_torch.ops.kvquant import kv_parts
from nemotron_tpu_torch.streaming.engine import BatchedEngine

torch.set_num_threads(1)


def run_until_idle(engine, limit=500):
    events = []
    for _ in range(limit):
        ev, more = engine.tick()
        events.extend(ev)
        if not more:
            return events
    raise AssertionError("engine did not go idle")


def texts_by_stream(events):
    out, ended = {}, set()
    for e in events:
        out[e.stream_id] = out.get(e.stream_id, "") + e.text
        if e.kind == "ended":
            ended.add(e.stream_id)
    return out, ended


def test_backlog_ticks_advance_k_chunks_and_match():
    check_backlog_ticks(build_model())


def check_backlog_ticks(model):
    engine = BatchedEngine(model, batch_per_group=2)
    audios = [make_audio(96 + 20 * 1280 + 300, seed=11),
              make_audio(96 + 18 * 1280, seed=12)]  # ends on a chunk boundary
    sids = [engine.start_stream(0) for _ in audios]
    for sid, a in zip(sids, audios):
        engine.push_audio(sid, a)
    events = run_until_idle(engine)  # the streams are idle, not ended
    so_far, ended = texts_by_stream(events)
    assert not ended
    assert [engine.transcript(s) for s in sids] == [so_far[s] for s in sids]
    for sid in sids:
        engine.end_stream(sid)
    got, ended = texts_by_stream(events + run_until_idle(engine))
    group = engine.groups[0]
    assert group.total_chunk_steps > group.total_steps  # k=8 ticks ran
    assert ended == set(sids)
    assert [got[s] for s in sids] == [direct_transcript(model, a, batch=2)
                                      for a in audios]


def test_staggered_join_starve_and_resume_match():
    check_staggered_join_starve_and_resume(build_model())


def check_staggered_join_starve_and_resume(model):
    engine = BatchedEngine(model, batch_per_group=4)
    audios = [make_audio(n, seed=20 + i)
              for i, n in enumerate((14000, 17000, 9000))]
    pos = [0, 0, 0]
    sids = [None, None, None]
    shift = 1280
    # per round, how many chunks each stream pushes (0 = starves; the
    # engine pauses it and realigns its window when it resumes)
    schedule = [(1, 0, 0), (1, 1, 0), (1, 0, 1), (0, 0, 1), (1, 1, 1),
                (2, 0, 1), (1, 3, 0), (0, 2, 2), (1, 1, 1), (3, 3, 3)]
    events = []
    for rnd in schedule:
        for i, n in enumerate(rnd):
            if n and sids[i] is None:
                sids[i] = engine.start_stream(0)
            if sids[i] is not None and pos[i] < len(audios[i]):
                take = n * shift + (96 if pos[i] == 0 and n else 0)
                engine.push_audio(sids[i], audios[i][pos[i]:pos[i] + take])
                pos[i] += take
        for _ in range(3):
            events.extend(engine.tick()[0])
    for i, sid in enumerate(sids):
        engine.push_audio(sid, audios[i][pos[i]:])
        engine.end_stream(sid)
    events.extend(run_until_idle(engine))
    got, ended = texts_by_stream(events)
    assert ended == set(sids)
    assert [got[s] for s in sids] == [direct_transcript(model, a)
                                      for a in audios]
    stats = engine.stats()["groups"][0]
    assert stats["chunk_steps"] >= 10 and stats["active_slots"] == 0


def test_prewarm_leaves_a_clean_group():
    check_prewarm_leaves_a_clean_group(build_model())


def check_prewarm_leaves_a_clean_group(model):
    engine = BatchedEngine(model, batch_per_group=4)
    engine.prewarm()
    group = engine.groups[0]
    assert group.phase == 0 and not group.slot_phase.any()
    assert not any(t.any() for t in kv_parts(group.state.k_cache))
    assert not group.state.pp_tail.any()
    audio = make_audio(7000, seed=30)
    sid = engine.start_stream(0)
    engine.push_audio(sid, audio)
    engine.end_stream(sid)
    got, ended = texts_by_stream(run_until_idle(engine))
    assert ended == {sid}
    assert got[sid] == direct_transcript(model, audio)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("timers", [False, True],
                         ids=["packed", "phase-timers"])
def test_ends_never_make_a_tick_collect_its_own_step(depth, timers):
    model = build_model()
    engine = BatchedEngine(model, batch_per_group=4, readback_depth=depth,
                           phase_timers=timers)
    shift = 1280
    # A, B, C: two whole chunks, ending on the boundary; D: four chunks
    audios = [make_audio(96 + n * shift, seed=50 + i)
              for i, n in enumerate((2, 2, 2, 4))]
    sids = [engine.start_stream(0) for _ in audios]
    group = engine.groups[0]
    for sid, a in zip(sids, audios):
        engine.push_audio(sid, a)
    events = []

    def tick():
        ev, more = engine.tick()
        events.extend(ev)
        return [e for e in ev if e.kind == "ended"], more

    for _ in range(2):  # every stream's first two chunks
        assert tick() == ([], True)
    for sid in sids[:3]:
        engine.end_stream(sid)
    # A, B and C end while D's third chunk dispatches: the tick collects
    # the step before (A, B and C's last text), not its own
    assert tick() == ([], True)
    assert group.total_steps == 3 and len(group._pending_q) == 1
    assert all(group.slots[i] is not None for i in range(3))
    # the next dispatching tick collects that step, then the three ends
    ended, _ = tick()
    assert [e.stream_id for e in ended] == sids[:3]
    assert group.total_steps == 4
    assert all(group.slots[i] is None for i in range(3))
    # E joins with one chunk as D ends: D's end waits on E's step; the
    # idle tick after collects it, D's end and E's own end, and frees
    # every slot
    e_audio = make_audio(96 + shift, seed=60)
    sids.append(engine.start_stream(0))
    engine.push_audio(sids[4], e_audio)
    engine.end_stream(sids[4])
    engine.end_stream(sids[3])
    assert tick() == ([], True)
    assert group.total_steps == 5
    ended, more = tick()
    assert group.total_steps == 5  # an idle tick
    assert [e.stream_id for e in ended] == sids[3:] and not more
    assert not group._pending_q and group.n_active_streams == 0
    assert all(s is None for s in group.slots)

    # every stream's `ended` follows its last text; no readback waited
    # on its own tick's step
    last = {e.stream_id: n for n, e in enumerate(events) if e.text}
    ends = {e.stream_id: n for n, e in enumerate(events)
            if e.kind == "ended"}
    assert sorted(ends) == sorted(sids)
    assert all(ends[s] > last.get(s, -1) for s in sids)
    assert len(last) >= 3  # the streams emit text
    st = engine.stats()["groups"][0]
    assert st["readbacks_same_tick"] == 0
    assert group.spans.calls["engine.readback_wait"] == st["steps"] == 5
    assert st["ended_events"] == 5
