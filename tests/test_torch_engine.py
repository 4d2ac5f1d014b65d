"""The port's BatchedEngine on the CPU, ticked by hand: every stream's
transcript equals the direct tick loop over its audio (exact tokens) when
the engine takes the k=8 backlog path, and when streams join late, starve
mid-stream (masked ticks, realign on resume, masked wrap compaction) and
end on and off chunk boundaries. The checks take the model, so that
tests/test_torch_serve_int8.py runs them on the int8 configuration."""

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
