"""Backlogged streams, saturating: clients that send faster than real time,
or reconnect with buffered audio.

Every slot holds a stream whose whole audio (a life drawn log-uniform from
the mix's range) was pushed, and ended, at once; when a stream's final
event comes, a new one takes its slot. The engine ticks back to back and
fuses up to max_safe_tick_chunks chunk steps a tick where every slot is
steady. The first cohort's lengths are what is left of random lives, so
the slots do not end in step; the warm-up before the window lets them mix.

What the run counts is the audio read back: each stream's progress is the
decode position of its newest event (all its audio once its final event
came), and the window's audio is the progress made between its start and
its end over every stream.
"""

from __future__ import annotations

import sys

import numpy as np

from portbench import gen
from portbench.streams import StreamBook, clock
from portbench.trace import span


def calibration_right_context(mix: dict) -> int:
    """The encoder mode the blank's bias is set in (calibrate.py): the
    mix's own right context."""
    return int(mix["right_context"])


class Run:
    def __init__(self, model, rec: dict):
        cell = rec["cell"]
        self.rec = rec
        self.mix = cell["traffic"]
        self.slots = int(cell["sizes"]["slots"])
        self.rc = int(self.mix["right_context"])
        self.book = StreamBook(model, rec, self.slots, self.rc)
        self.seed = rec["seed"]
        rec["shape"] = {"slots": self.slots, "right_context": self.rc,
                        "hp": cell["config"]["model"]}

    def _lengths(self):
        """The first cohort's samples, then the lengths that follow (a set
        of `cycle` lengths, repeated)."""
        lo, hi = self.mix["life_s"]
        r = gen.rng(self.seed, "backlog")
        n = self.slots
        first = gen.residual_lives(gen.quantiles(n, r), gen.quantiles(n, r),
                                   lo, hi, floor=2.0)
        then = gen.log_uniform(gen.quantiles(int(self.mix["cycle"]), r),
                               lo, hi)
        self.pool = gen.mix_pool(self.mix, self.seed, self.rec["device"])
        self.r = r
        to_n = (lambda s: (np.asarray(s) * gen.SAMPLE_RATE).astype(np.int64))
        return to_n(first), to_n(then)

    def _start(self, n: int) -> None:
        off = int(self.r.random() * (len(self.pool) - n))
        s = self.book.start(clock(), off, n)
        if s is None:
            self.refused += 1
            return
        self.book.engine.push_audio(s.sid, self.pool[off:off + n])
        self.book.engine.end_stream(s.sid)
        s.end_called = s.start

    def setup(self) -> None:
        self.book.prewarm()
        first, self.then = self._lengths()
        self.k = 0
        self.refused = 0
        for n in first:
            self._start(int(n))
        self._run(clock() + float(self.mix["warm_s"]))

    def _run(self, until: float) -> None:
        book, engine = self.book, self.book.engine
        while clock() < until:
            with span("tick"):
                events, _ = engine.tick()
            with span("events"):
                for _s in book.take(events, clock(), None):
                    self._start(int(self.then[self.k % len(self.then)]))
                    self.k += 1

    def window(self) -> None:
        rec, book = self.rec, self.book
        seconds = float(rec["seconds"])
        t0 = rec["t_window"]
        t1 = t0 + seconds
        p0 = {sid: s.progress for sid, s in book.streams.items()}
        n0 = {sid: len(s.tokens) for sid, s in book.streams.items()}
        c0 = book.counters()
        self.refused = 0
        if rec["trace"]:
            trace_s = min(float(self.mix["trace_s"]), seconds)
            self._run(t0 + (seconds - trace_s) / 2)
            stretch = book.stretch()
            stretch.start()
            self._run(clock() + trace_s)
            rec["profile"] = stretch.stop()
        self._run(t1)
        rec["window_s"] = clock() - t0
        c1 = book.counters()
        rec["window_counters"] = {k: c1[k] - c0[k] for k in c1}
        rec["stream_audio_s"] = sum(s.progress - p0.get(s.sid, 0.0)
                                    for s in book.streams.values())
        tokens = sum(len(s.tokens) - n0.get(s.sid, 0)
                     for s in book.streams.values())
        frames = rec["stream_audio_s"] / rec["arch"].frame_seconds(
            rec["cell"]["config"])
        print(f"window: {tokens} tokens served over {frames:.0f} encoder "
              f"frames",
              file=sys.stderr, flush=True)
        # the streams finished in the window, and any start refused for
        # want of a slot (a stream that never finishes holds its slot, and
        # the window's audio stops growing)
        done = [s for s in book.streams.values()
                if s.ended_at is not None and t0 <= s.ended_at < t1]
        rec["attempted"] = len(done) + self.refused
        rec["failed"] = self.refused

    def samples(self) -> list[dict]:
        return self.book.samples(self.pool, int(self.mix["sample_streams"]),
                                 self.seed)

    def close(self) -> None:
        self.book.close()
