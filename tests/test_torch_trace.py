"""The port's spans (nemotron_tpu_torch/utils/trace.py) on the CPU, at the
tiny widths: with no profiler running a span only adds to its table (no
record_function); under a torch.profiler session each engine tick is one
`nt:engine.tick` event of the trace with its phases inside it, and the
root's counts are what the tick did; stats() reads the group's table; an
offline call is one `offline.call` event with its mel, its segments and
their steps, and each segment's stats carry its spans' seconds; the
native server's loop totals name its four parts."""

import pytest
import torch

from test_torch_server import build_model, make_audio

from nemotron_tpu_torch.streaming.engine import BatchedEngine
from nemotron_tpu_torch.utils import trace

torch.set_num_threads(1)

TICK_PHASES = ("engine.admin", "engine.ingest", "engine.prime",
               "engine.scan", "engine.take", "engine.more")
STEP_PHASES = ("engine.slot_ops", "engine.upload", "engine.dispatch")
# stats()'s keys before the spans (and with phase_timers, the halves')
OLD_KEYS = {"active_slots", "ticks", "steps", "chunk_steps", "chunks",
            "audio_seconds", "step_seconds", "transfer_seconds",
            "upload_seconds", "tick_seconds", "pack_seconds",
            "scatter_seconds", "dispatch_seconds", "rtf", "emit_latency_ms",
            "graphs"}


@pytest.fixture(scope="module")
def model():
    return build_model()


def profiling():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


class Node:
    def __init__(self, name, start, end):
        self.name, self.start, self.end = name, start, end
        self.kids: list = []

    def names(self) -> list:
        return [k.name for k in self.kids]


def span_tree(prof) -> list:
    """The session's `nt:` events as a forest, each child inside its
    parent, in the order they started; names without the prefix."""
    evs = sorted(((e.start_ns(), -(e.start_ns() + e.duration_ns()),
                   e.name()[len(trace.PREFIX):])
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(trace.PREFIX)))
    roots, stack = [], []
    for start, neg_end, name in evs:
        node = Node(name, start, -neg_end)
        while stack and stack[-1].end < node.end:
            stack.pop()
        (stack[-1].kids if stack else roots).append(node)
        stack.append(node)
    return roots


def drive(engine, n_streams=3, seed=40):
    """Streams that join on different ticks, push in bursts, pause, and
    end: masked and all-active ticks, resumes, finalizations. Returns
    [(events, more)] of every tick and, per tick, the active rows it
    dispatched (None for a tick that dispatched nothing)."""
    model = engine.model
    dispatched = []
    pack = model.pack_tick_inputs
    prof = model.fused_tick_profiled

    def counting_pack(block, n_valid, prompt_idx, active):
        dispatched[-1] = block.shape[0] if active is None \
            else int(active.sum())
        return pack(block, n_valid, prompt_idx, active)

    def counting_prof(cfg, state, block, nv, active, *a, **kw):
        dispatched[-1] = block.shape[0] if active is None \
            else int(active.sum())
        return prof(cfg, state, block, nv, active, *a, **kw)

    model.pack_tick_inputs = counting_pack
    model.fused_tick_profiled = counting_prof
    audios = [make_audio(96 + 1280 * (5 + 2 * i) + 300, seed=seed + i)
              for i in range(n_streams)]
    sids, pos, out = [None] * n_streams, [0] * n_streams, []
    try:
        for rnd in range(40):
            for i, a in enumerate(audios):
                if rnd < i or pos[i] >= len(a) or rnd % (i + 2) == 1:
                    continue
                if sids[i] is None:
                    sids[i] = engine.start_stream(0)
                n = 96 + 1280 if pos[i] == 0 else 1280 * (1 + rnd % 2)
                engine.push_audio(sids[i], a[pos[i]:pos[i] + n])
                pos[i] += n
                if pos[i] >= len(a):
                    engine.end_stream(sids[i])
            dispatched.append(None)
            out.append(engine.tick())
        while out[-1][1]:
            dispatched.append(None)
            out.append(engine.tick())
    finally:
        del model.pack_tick_inputs, model.fused_tick_profiled
    assert all(s is not None for s in sids)
    return out, dispatched


def test_no_profiler_no_record_function(model, monkeypatch):
    """Ticks, an offline call and a phase-timed tick with no profiler
    running: the tables fill, and record_function, patched to raise, is
    never entered."""
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for timers in (False, True):
        engine = BatchedEngine(model, batch_per_group=3, readback_depth=1,
                               phase_timers=timers)
        drive(engine)
        g = engine.groups[0]
        assert g.spans.calls["engine.tick"] == g.total_ticks > 0
        assert g.spans.calls["engine.step"] == g.total_steps > 0
        assert g.spans.calls["engine.dispatch"] == g.total_steps
    text = model.transcribe_audios([make_audio(96000, 3),
                                    make_audio(12800, 4)])
    assert len(text) == 2
    assert model.offline_spans.calls["offline.segment"] == 2


@pytest.mark.parametrize("depth, timers", [(1, False), (2, False),
                                           (2, True)])
def test_traced_ticks(model, depth, timers):
    """Under a CPU profiler: one `nt:engine.tick` event a tick, with its
    phases inside it, a dispatching tick's step phases inside its
    `engine.step`, the readbacks inside the tick that collects them; the
    table counts one call a span of the trace, the rows of the dispatched
    active masks and the events tick() returned; stats() reads the
    table."""
    engine = BatchedEngine(model, batch_per_group=3, readback_depth=depth,
                           phase_timers=timers)
    engine.prewarm()
    g = engine.groups[0]
    ticks0 = g.total_ticks
    waits0 = g.spans.calls["engine.readback_wait"]
    with profiling() as prof:
        with torch.profiler.record_function("warm"):  # its lazy set-up
            pass
        ticks, dispatched = drive(engine)
    roots = span_tree(prof)
    assert [r.name for r in roots] == ["engine.tick"] * len(ticks)
    assert g.total_ticks - ticks0 == len(ticks)

    disp, got = [], []  # tick of each dispatch, of each readback
    for i, (root, rows) in enumerate(zip(roots, dispatched)):
        names = root.names()
        assert [n for n in names if n in TICK_PHASES] == list(TICK_PHASES)
        assert ("engine.step" in names) == (rows is not None)
        inner = names
        if rows is not None:
            disp.append(i)
            (step,) = [k for k in root.kids if k.name == "engine.step"]
            inner = step.names()
            assert set(STEP_PHASES) <= set(inner)
            assert ("engine.pack" in inner) != timers
            if timers:
                (dispatch,) = [k for k in step.kids
                               if k.name == "engine.dispatch"]
                assert dispatch.names() == ["engine.encoder",
                                            "engine.decoder"]
        if inner is not names:  # a dispatching tick collects in its step
            assert "engine.readback_wait" not in names
        waits = inner.count("engine.readback_wait")
        assert waits == inner.count("engine.scatter")
        got += [i] * waits
    # each step read back once, in order, at most `depth` ticks late
    assert len(got) == len(disp) == g.spans.calls["engine.readback_wait"] \
        - waits0
    assert all(0 <= c - d <= depth for d, c in zip(disp, got))
    assert sum(r is not None and r < 3 for r in dispatched)  # masked ticks

    st = engine.stats()["groups"][0]
    assert OLD_KEYS | ({"encoder_seconds", "decoder_seconds"} if timers
                       else set()) <= set(st)
    secs = g.spans.seconds
    for key, span in (("tick_seconds", "tick"), ("step_seconds", "step"),
                      ("transfer_seconds", "readback_wait"),
                      ("upload_seconds", "upload"),
                      ("pack_seconds", "pack"),
                      ("scatter_seconds", "scatter"),
                      ("dispatch_seconds", "dispatch"),
                      ("admin_seconds", "admin"), ("scan_seconds", "scan"),
                      ("slot_ops_seconds", "slot_ops"),
                      ("encoder_seconds", "encoder"),
                      ("decoder_seconds", "decoder")):
        if key in st:
            assert st[key] == round(secs.get("engine." + span, 0.0), 3)
    # the always-on counters: the tables' sums, traced or not
    rows = [r for r in dispatched if r is not None]
    assert st["rows_active"] == sum(rows)
    assert st["rows_dispatched"] == 3 * len(rows) == 3 * st["steps"]
    n_text = sum(e.kind == "text" for evs, _ in ticks for e in evs)
    n_ended = sum(e.kind == "ended" for evs, _ in ticks for e in evs)
    assert st["text_events"] == n_text > 0
    assert st["ended_events"] == n_ended == 3


@pytest.mark.parametrize("entry", ["transcribe_audios", "transcribe_audio",
                                   "transcribe_mel"])
def test_traced_offline_call(model, entry):
    """Two files, one past the segment cap (two segment windows): one
    `offline.call` event; its mel (from PCM), one `offline.segment` per
    window with its pad, upload, encoder, decode (its exit tests inside)
    and tokens, and its detokenizer (to text). Each segment's stats carry
    its encoder's and decode's seconds, which sum to the table's."""
    audios = [make_audio(96000, 5), make_audio(12800, 6)]
    with profiling() as prof:
        if entry == "transcribe_audios":
            model.transcribe_audios(audios)
        elif entry == "transcribe_audio":
            model.transcribe_audio(audios[0])
        else:
            model.transcribe_mel(model._preprocessor().process(audios[0]))
    (call,) = span_tree(prof)
    assert call.name == "offline.call"
    segments = ["offline.segment"] * len(model.offline_stats)
    assert len(segments) == 2
    assert call.names() == (segments if entry == "transcribe_mel" else
                            ["offline.mel"] + segments + ["offline.detok"])
    for seg in call.kids:
        if seg.name != "offline.segment":
            continue
        assert seg.names() == ["offline.pad", "offline.upload",
                               "offline.encoder", "offline.decode",
                               "offline.tokens"]
        assert set(seg.kids[3].names()) == {"offline.exit_test"}
    table = model.offline_spans
    assert table.calls["offline.call"] == 1
    assert table.calls["offline.exit_test"] >= 2
    for key, span in (("encoder_seconds", "offline.encoder"),
                      ("decode_seconds", "offline.decode")):
        assert all(s[key] > 0 for s in model.offline_stats)
        assert sum(s[key] for s in model.offline_stats) == pytest.approx(
            table.seconds[span], rel=1e-9)


def test_native_server_loop_totals(monkeypatch):
    """The native server's loop: its table's wait, control, tick and
    deliver under the four names of the `[stats]` line; the engine's
    ticks inside the loop's."""
    import test_torch_native_server as tns

    from nemotron_tpu_torch.config import CacheConfig

    monkeypatch.setitem(CacheConfig._MODE_N_PHASES, 0, tns.N_PHASES)
    m = tns.TorchModel.random(tns.tiny_hparams(), seed=1, device="cpu")
    with tns.running_server(m) as rs:
        assert tns.serve_file(rs, tns.make_audio(9600, seed=1))
    srv = rs.srv
    secs = srv.loop_seconds
    assert list(secs) == ["wait", "control", "tick", "deliver"]
    assert all(v > 0 for v in secs.values()), secs
    assert secs["tick"] >= srv.engine.groups[0].spans.seconds["engine.tick"]
    assert set(srv.spans.calls) == {"server.wait", "server.control",
                                    "server.tick", "server.deliver"}
    assert srv.spans.calls["server.tick"] >= \
        srv.engine.groups[0].spans.calls["engine.tick"]
