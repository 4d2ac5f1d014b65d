"""Live streams, open loop: the traffic users send to captions and voice
agents.

Streams arrive as a Poisson process whose rate keeps the cell's mean
concurrency ("streams" in the cell file); each lasts a life drawn
log-uniform from the mix's range and sends one packet of audio each
packet period, due when its last sample would have been spoken. The
streams live at the window's start were started `warm_s` before it with
what is left of a random life, at phases spread over the packet period, so
the window opens on a churning, unaligned population in steady state.

One thread pushes every due packet, calls BatchedEngine.tick() and books
the events; it sleeps only when no packet is due and the engine has no
work. The lag of a text event is the time it was returned less the time
its audio was due (the stream's start plus the event's decode position),
so a stall counts against every chunk behind it. A stream refused for
want of a slot, or one ended in the window whose final event never came,
counts as failed.
"""

from __future__ import annotations

import heapq
import sys
import time

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
        self.n_streams = int(cell["sizes"]["streams"])
        self.slots = int(cell["sizes"]["slots"])
        self.rc = int(self.mix["right_context"])
        self.book = StreamBook(model, rec, self.slots, self.rc)
        self.seed = rec["seed"]
        rec["shape"] = {"slots": self.slots, "right_context": self.rc,
                        "hp": cell["config"]["model"]}

    # --- the schedule ---------------------------------------------------
    def _schedule(self):
        """[(start relative to the window's start, offset, samples)]."""
        mix, n = self.mix, self.n_streams
        lo, hi = mix["life_s"]
        warm, seconds = float(mix["warm_s"]), float(self.rec["seconds"])
        period = mix["packet_ms"] / 1000.0
        r = gen.rng(self.seed, "live")
        first = gen.residual_lives(gen.quantiles(n, r), gen.quantiles(n, r),
                                   lo, hi, floor=period)
        phase = gen.quantiles(n, r) * period
        starts = [-warm + p for p in phase]
        lives = list(first)
        rate = n / gen.log_uniform_mean(lo, hi)
        horizon = warm + seconds
        n_new = int(np.ceil(rate * horizon * 1.1)) + 1
        t = -warm + np.cumsum(gen.exp_gaps(n_new, rate, r))
        keep = t < seconds
        starts += list(t[keep])
        lives += list(gen.log_uniform(gen.quantiles(n_new, r), lo, hi)[keep])
        self.pool = gen.mix_pool(self.mix, self.seed, self.rec["device"])
        ns = (np.asarray(lives) * gen.SAMPLE_RATE).astype(np.int64)
        offs = (r.random(len(ns)) * (len(self.pool) - ns)).astype(np.int64)
        order = np.argsort(starts, kind="stable")
        return [(float(starts[i]), int(offs[i]), int(ns[i])) for i in order]

    # --- the loop ---------------------------------------------------------
    def setup(self) -> None:
        self.book.prewarm()
        self.plan = self._schedule()
        # the window opens warm_s after the first streams start
        self.t0 = clock() + float(self.mix["warm_s"])
        self.lags: list[float] = []
        self.late: list[float] = []
        self.tick_s: list[float] = []
        self.next = 0   # the next stream of the plan to start
        self.due: list = []  # (due time, stream id, packet index)
        self._run(self.t0, record=False)

    def _run(self, until: float, record: bool) -> None:
        """Drive the loop up to host time `until` (see the module
        docstring); with `record`, book lags, lateness and tick times."""
        book, engine = self.book, self.book.engine
        period = self.mix["packet_ms"] / 1000.0
        step = int(round(period * gen.SAMPLE_RATE))
        plan = self.plan
        more = True
        while True:
            now = clock()
            if now >= until:
                return
            with span("push"):
                while self.next < len(plan) and \
                        self.t0 + plan[self.next][0] <= now:
                    start, off, n = plan[self.next]
                    self.next += 1
                    s = book.start(self.t0 + start, off, n)
                    if s is None:
                        if record:
                            self.refused_in_window += 1
                        continue
                    heapq.heappush(self.due, (s.start + min(step, n)
                                              / gen.SAMPLE_RATE, s.sid, 0))
                pushed = False
                while self.due and self.due[0][0] <= now:
                    due, sid, j = heapq.heappop(self.due)
                    s = book.streams[sid]
                    a, b = j * step, min((j + 1) * step, s.n)
                    engine.push_audio(sid, self.pool[s.offset + a:
                                                     s.offset + b])
                    pushed = True
                    if record:
                        self.late.append(now - due)
                    if b >= s.n:
                        engine.end_stream(sid)
                        s.end_called = now
                    else:
                        nb = min((j + 2) * step, s.n)
                        heapq.heappush(self.due, (s.start + nb
                                                  / gen.SAMPLE_RATE, sid,
                                                  j + 1))
            if pushed or more:
                t_tick = clock()
                with span("tick"):
                    events, more = engine.tick()
                done = clock()
                if record:
                    self.tick_s.append(done - t_tick)
                with span("events"):
                    book.take(events, done, self.lags if record else None)
                continue
            nxt = min(self.due[0][0] if self.due else until,
                      self.t0 + plan[self.next][0]
                      if self.next < len(plan) else until, until)
            with span("sleep"):
                time.sleep(max(0.0, nxt - clock()))

    def window(self) -> None:
        rec, book = self.rec, self.book
        seconds = float(rec["seconds"])
        t1 = self.t0 + seconds
        self.refused_in_window = 0
        progress0 = {sid: s.progress for sid, s in book.streams.items()}
        if rec["trace"]:
            trace_s = min(float(self.mix["trace_s"]), seconds)
            t_trace = self.t0 + (seconds - trace_s) / 2
            self._run(t_trace, record=True)
            stretch = book.stretch()
            stretch.start()
            self._run(clock() + trace_s, record=True)
            rec["profile"] = stretch.stop()
        self._run(t1, record=True)
        rec["window_s"] = clock() - self.t0
        rec["lags_s"] = self.lags
        rec["tick_s"] = self.tick_s
        late = np.asarray(self.late) * 1e3
        if late.size:
            print(f"generator lateness: median {np.median(late):.3f} ms, "
                  f"p95 {np.percentile(late, 95):.3f} ms, max "
                  f"{late.max():.3f} ms over {late.size} packets",
                  file=sys.stderr, flush=True)
        if len(self.lags) >= 8:
            # a backlog that grows shows as a lag that climbs
            q = [np.percentile(part, 95) * 1e3
                 for part in np.array_split(np.asarray(self.lags), 4)]
            print("lag p95 by quarter of the window: "
                  + " ".join(f"{x:.1f}" for x in q) + " ms",
                  file=sys.stderr, flush=True)
        # ended in the window: every one needs its final event
        ended_in = [s for s in book.streams.values()
                    if s.end_called is not None
                    and self.t0 <= s.end_called < t1]
        self._drain(ended_in, t1 + float(self.mix["drain_s"]))
        rec["stream_audio_s"] = sum(
            s.progress - progress0.get(s.sid, 0.0)
            for s in book.streams.values())
        missing = sum(1 for s in ended_in if s.ended_at is None)
        rec["attempted"] = len(ended_in) + self.refused_in_window
        rec["failed"] = missing + self.refused_in_window

    def _drain(self, streams, deadline: float) -> None:
        """Keep the live streams going, starting no new one, until each of
        `streams` has its final event."""
        self.next = len(self.plan)
        while clock() < deadline and any(s.ended_at is None for s in streams):
            self._run(min(clock() + 0.05, deadline), record=False)

    def samples(self) -> list[dict]:
        return self.book.samples(self.pool, int(self.mix["sample_streams"]),
                                 self.seed)

    def close(self) -> None:
        self.book.close()
