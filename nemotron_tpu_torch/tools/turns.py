"""What the turn tools of this directory share (gemm_turns.py,
graph_turns.py): the card's line, one child process per checkout in the
order given, the JSON they write, and the device time of a torch.profiler
trace.

A tool runs its own file once per tree as `--child PATH` in that tree,
so the child imports and builds that tree's package: two checkouts (a
parent and a change, e.g. parent, change, change, parent) compare on one
card in one call. This module imports nothing of the package, so a tool
can measure trees older than itself.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path


def card() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (the first card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def enter(tree: str) -> None:
    """In a child: import the package from `tree` (put it first on the
    path before anything imports it)."""
    sys.path.insert(0, tree)


def run_child(script: str, label: str, tree: str, args=(),
              timeout: float = 900) -> dict | None:
    """`script --child TREE *args` run in TREE; its last line of output
    parsed as JSON, or None (the tail of its errors printed) when it
    fails."""
    path = os.path.abspath(tree)
    res = subprocess.run(
        [sys.executable, os.path.abspath(script), "--child", path, *args],
        capture_output=True, text=True, cwd=path, timeout=timeout)
    if res.returncode != 0:
        print(f"{label}: failed\n{res.stderr[-3000:]}", flush=True)
        return None
    return json.loads(res.stdout.strip().splitlines()[-1])


def write_json(dest: str | None, card_line: str, runs: list) -> None:
    """{"card": card_line, "runs": runs} into `dest` (nothing if None)."""
    if dest:
        path = Path(dest)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"card": card_line, "runs": runs},
                                   indent=1))


def device_ns(prof) -> dict:
    """{kernel name: (device ns, launches)} of a torch.profiler trace's
    CUDA activity, summed from the raw trace (an offline call issues tens
    of thousands of kernels, too many for key_averages)."""
    from torch.autograd import DeviceType

    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ns, n = out.get(e.name(), (0, 0))
            out[e.name()] = (ns + e.duration_ns(), n + 1)
    return out


def union_ns(spans) -> int:
    """The length of the union of [start, end) spans: the time in which at
    least one of them ran."""
    total, hi = 0, None
    for start, end in sorted(spans):
        if hi is None or start > hi:
            total += end - start
            hi = end
        elif end > hi:
            total += end - hi
            hi = end
    return total


def union_ms(prof) -> dict:
    """{device index: ms in which some CUDA activity of a torch.profiler
    trace ran on that device}: the union of the activities' spans, so work
    that overlaps on streams of one card (a tp group's ranks) counts once,
    where device_ns sums it."""
    from torch.autograd import DeviceType

    spans: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            spans.setdefault(e.device_index(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return {d: union_ns(s) / 1e6 for d, s in spans.items()}


def busy_ms(prof) -> float | None:
    """A trace's device time in ms (device_ns summed), or None if it
    holds none."""
    ns = sum(ns for ns, _ in device_ns(prof).values())
    return ns / 1e6 if ns else None
