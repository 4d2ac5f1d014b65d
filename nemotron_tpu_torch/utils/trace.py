"""Spans of the port's phases: the engine tick's, the offline call's and
the native server loop's.

A caller owns a `Totals` table (each EngineGroup, ASRModel's offline path
and the native server's loop own one) and opens spans on it:

    with totals.span("engine.tick") as sp:
        ...
        sp.set(rows_active=n)

Always, a span times itself with one clock pair (perf_counter_ns) and adds
its seconds, one call and its counts to the table under its name; that is
what `BatchedEngine.stats()` and the native server's `[stats]` line read.

Only while a torch.profiler session runs (one check of the profiler's
flag per span), a span also opens `torch.profiler.record_function("nt:" +
name)`, so that it sits in the session's trace, beside every op it
encloses, on the profiler's own clock. Nothing is kept or written out
beyond the table: the session's trace holds the `nt:` events.

Spans are per phase: none is opened inside a loop over slots, rows or
files, and per-row facts are counts on the phase's span.
"""

from __future__ import annotations

import collections
import time

import torch

PREFIX = "nt:"

# whether a profiler session runs (the C++ profiler's state: a
# torch.profiler session, however it was started)
_profiling = torch._C._autograd._profiler_enabled


class Totals:
    """A caller's table: seconds, calls and summed counts by span name."""

    def __init__(self):
        self.seconds: dict = collections.defaultdict(float)
        self.calls: dict = collections.defaultdict(int)
        self.counts: dict = collections.defaultdict(int)  # (name, key)

    def span(self, name: str, **counts) -> "Span":
        return Span(self, name, counts)

    def count(self, name: str, key: str) -> int:
        return self.counts.get((name, key), 0)


class Span:
    __slots__ = ("totals", "name", "counts", "seconds", "_t0", "_rf")

    def __init__(self, totals: Totals, name: str, counts: dict):
        self.totals = totals
        self.name = name
        self.counts = counts
        self.seconds = 0.0

    def set(self, **counts) -> None:
        self.counts.update(counts)

    def __enter__(self) -> "Span":
        self._rf = None
        if _profiling():
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = (time.perf_counter_ns() - self._t0) * 1e-9
        t, name = self.totals, self.name
        t.seconds[name] += self.seconds
        t.calls[name] += 1
        for k, v in self.counts.items():
            t.counts[name, k] += v
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        return False
