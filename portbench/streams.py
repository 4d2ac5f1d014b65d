"""What the streaming traffic kinds share: the program's engine, the book of
every stream the run started, what each was served, the samples the judge
compares, and the traced stretch's program counters."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import gen
from .trace import Stretch


@dataclasses.dataclass
class Stream:
    sid: int
    start: float          # host clock at which its audio time 0 was due
    offset: int           # its audio: pool[offset:offset + n]
    n: int
    record: object        # the engine's slot record of the stream
    tokens: list = dataclasses.field(default_factory=list)  # from its text
    progress: float = 0.0  # audio seconds read back
    end_called: float | None = None  # host clock of its end_stream
    ended_at: float | None = None   # host clock of its final event
    end_pos: float = -1.0  # the final event's decode position (s)


class StreamBook:
    def __init__(self, model, rec: dict, slots: int, right_context: int):
        from nemotron_tpu_torch.streaming.engine import BatchedEngine

        self.rec = rec
        self.rc = right_context
        self.engine = BatchedEngine(model, batch_per_group=slots)
        self.streams: dict[int, Stream] = {}
        self.cuda = rec["device"] == "cuda"

    def prewarm(self) -> None:
        self.engine.prewarm((self.rc,))

    @property
    def group(self):
        return self.engine.groups[self.rc]

    def start(self, when: float, offset: int, n: int) -> Stream | None:
        """A new stream whose audio time 0 is due at host time `when`;
        None where the engine refuses it for want of a slot."""
        try:
            sid = self.engine.start_stream(right_context=self.rc)
        except RuntimeError:
            return None
        group = self.group
        s = Stream(sid, when, offset, n, group.slots[group.find(sid)])
        self.streams[sid] = s
        return s

    def take(self, events, now: float, lags: list | None) -> list[Stream]:
        """Book a tick's events: each text's tokens and decode position,
        its lag (now - the time its audio was due) into `lags`; returns
        the streams that ended."""
        ended = []
        for e in events:
            s = self.streams.get(e.stream_id)
            if s is None:
                continue
            if e.text:
                s.tokens.extend(gen.parse_text(e.text)[0])
                if lags is not None:
                    lags.append(now - (s.start + e.at_sec))
            if e.at_sec >= 0:
                s.progress = max(s.progress, e.at_sec)
            if e.kind == "ended":
                s.ended_at = now
                s.end_pos = e.at_sec
                s.progress = s.n / gen.SAMPLE_RATE
                ended.append(s)
        return ended

    def counters(self) -> dict:
        g = self.engine.stats()["groups"].get(self.rc, {})
        return {k: g.get(k, 0) for k in ("ticks", "steps", "chunk_steps",
                                         "chunks")}

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def stretch(self) -> "Counted":
        return Counted(self)

    def samples(self, pool: np.ndarray, k: int, seed: int) -> list[dict]:
        """k finished streams drawn from the seed, the longest among
        them: their audio and what they were served."""
        done = [s for s in self.streams.values() if s.ended_at is not None]
        if not done:
            return []
        longest = max(done, key=lambda s: s.n)
        rest = [s for s in done if s is not longest]
        r = gen.rng(seed, "sample")
        pick = [longest] + [rest[i] for i in r.permutation(len(rest))[:k - 1]]
        out = []
        for s in pick:
            out.append({
                "kind": "stream", "right_context": self.rc,
                "audio": pool[s.offset:s.offset + s.n],
                "served": list(zip(s.record.tokens, s.record.token_frames)),
                "text_tokens": s.tokens, "end_pos": s.end_pos})
        return out

    def close(self) -> None:
        self.engine = None
        self.streams.clear()


class Counted:
    """A traced stretch with the engine's counters at both ends."""

    def __init__(self, book: StreamBook):
        self.book = book
        self.stretch = Stretch(book.sync)

    def start(self) -> None:
        self.stretch.start()
        self.c0 = self.book.counters()

    def stop(self) -> dict | None:
        prof = self.stretch.stop()
        c1 = self.book.counters()
        if prof is not None:
            prof["counters"] = {k: c1[k] - self.c0[k] for k in c1}
        return prof


def clock() -> float:
    return time.perf_counter()
