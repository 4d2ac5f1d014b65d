"""The live traffic kind times each text event from when its audio was due, not
from when it was pushed: a stall of the engine counts against every chunk
behind it. It runs here over a stub engine that decodes each
packet the moment it ticks, and stalls once."""

from __future__ import annotations

import types

import numpy as np
import pytest

from portbench import gen

STALL_S = 0.4


class StubEngine:
    """BatchedEngine's surface as kinds/live.py uses it: each tick returns a
    text event per packet pushed since the last one, at the packet's end
    in stream seconds; the first tick from host time `stall_at` on sleeps
    STALL_S first."""

    def __init__(self):
        self.slots = []
        self.groups = {0: self}
        self.pending = []
        self.pos = {}
        self.stall_at = float("inf")

    def find(self, sid):
        return sid - 1

    def start_stream(self, right_context=0):
        self.slots.append(types.SimpleNamespace(tokens=[], token_frames=[]))
        sid = len(self.slots)
        self.pos[sid] = 0
        return sid

    def push_audio(self, sid, audio):
        self.pos[sid] += len(audio)
        self.pending.append(types.SimpleNamespace(
            stream_id=sid, kind="text", text=" w1",
            at_sec=self.pos[sid] / gen.SAMPLE_RATE))

    def end_stream(self, sid):
        self.pending.append(types.SimpleNamespace(
            stream_id=sid, kind="ended", text="", at_sec=-1.0))

    def tick(self):
        import time

        if time.perf_counter() >= self.stall_at:
            self.stall_at = float("inf")
            time.sleep(STALL_S)
        out, self.pending = self.pending, []
        return out, False


def test_lag_is_timed_from_the_due_time(tiny_suite):
    from portbench.archs.fastconformer_rnnt import model as model_mod

    cell = tiny_suite.cell("tiny-live")
    cell["traffic"] = dict(cell["traffic"], warm_s=0.3, life_s=[2.0, 4.0])
    rec = {"cell": cell, "seed": 7, "seconds": 1.5, "trace": False,
           "device": "cpu", "kernel_ops": {}}
    w = model_mod.make_weights(cell["config"], 7, "cpu")
    run = tiny_suite.kind("live").Run(
        model_mod.program_model(cell["config"], w, "cpu"), rec)
    stub = StubEngine()
    run.book.engine = stub
    run.book.prewarm = lambda: None
    run.setup()
    stub.stall_at = run.t0 + 0.5
    rec["t_window"] = run.t0
    run.window()
    lags = np.asarray(rec["lags_s"])
    assert lags.size > 50
    # decoded at once: a lag is the wait for the loop, a few ms, except
    # behind the stall, where packets due during it wait up to STALL_S
    assert np.median(lags) < 0.05
    assert lags.max() == pytest.approx(STALL_S, abs=0.1)
    assert (lags > 0.5 * STALL_S).sum() >= 4  # every stream behind it
    assert min(rec["tick_s"]) >= 0 and max(rec["tick_s"]) >= STALL_S
    assert rec["failed"] == 0
