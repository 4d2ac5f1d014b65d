"""A traced stretch of the window: torch.profiler over the host and the
card, between two synchronisations, so that every kernel in the trace
belongs to work dispatched inside the stretch.

From the trace: the device's busy time as the union of the spans of every
CUDA activity (kernels, copies, sets; work that overlaps on two streams
counts once), the time of each kernel by name, and each idle gap of the
device attributed to what the host was doing at its middle (the innermost
host event: a span of the harness, `pb:*`, or an op of the program)."""

from __future__ import annotations

import bisect
import heapq
import time

NAME_CHARS = 96
SMALL_GAP_NS = 10_000


def span(name: str):
    """A host span of the harness, visible in the trace."""
    import torch

    return torch.profiler.record_function("pb:" + name)


class Stretch:
    def __init__(self, sync):
        self.sync = sync
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> dict | None:
        self.sync()
        window = time.perf_counter() - self.t0
        self.prof.stop()
        out = analyse(self.prof.profiler.kineto_results.events())
        self.prof = None
        if out is None:
            return None
        out["window_s"] = window
        return out


def _merged(spans):
    """The union of [start, end) spans as disjoint sorted spans."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def analyse(events) -> dict | None:
    """{"busy_s", "kernels": {name: [s, n]}, "device_ops", "idle_gaps"}
    of a trace's events, or None if it holds no device activity."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        d = e.duration_ns()
        if d <= 0:
            continue
        s = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            # a host span's mirror on the device timeline is no operation
            if e.name().startswith("pb:") or getattr(
                    e, "is_user_annotation", lambda: False)():
                continue
            dev.append((s, s + d, e.name()))
        else:
            host.append((s, s + d, e.name()))
    if not dev:
        return None
    kernels: dict = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) / 1e9
        k[1] += 1
    merged = _merged([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in merged)
    # the traced host stretch bounds the gaps before and after the work
    lo = min([s for s, _, _ in host] + [merged[0][0]])
    hi = max([e for _, e, _ in host] + [merged[-1][1]])
    gaps = []
    edge = lo
    for s, e in merged:
        if s > edge:
            gaps.append((edge, s))
        edge = e
    if hi > edge:
        gaps.append((edge, hi))
    idle: dict = {}
    host.sort()
    starts = [h[0] for h in host]
    active: list = []
    i = 0
    for gs, ge in sorted(gaps):
        if ge - gs < SMALL_GAP_NS:
            key = "gaps under 10 us"
        else:
            mid = (gs + ge) // 2
            j = bisect.bisect_right(starts, mid)
            while i < j:
                heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
                i += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)
            key = active[0][2][:NAME_CHARS] if active else "no host event"
        idle[key] = idle.get(key, 0.0) + (ge - gs) / 1e9
    ops = sorted(((n[:NAME_CHARS], v[0]) for n, v in kernels.items()),
                 key=lambda r: -r[1])
    return {"busy_s": busy / 1e9, "kernels": kernels,
            "device_ops": [list(r) for r in ops[:10]],
            "idle_gaps": [list(r) for r in sorted(
                idle.items(), key=lambda r: -r[1])[:10]]}
