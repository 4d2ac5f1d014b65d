"""Compiled executables: the port's counterpart of the JAX package's jitted
programs (nemotron_tpu/api.py `_memo`: one XLA program per key, built once
and reused, its state argument donated; the diarize nets' `jax.jit`). Here
each key's body (a tick, the offline encoder, a block of the offline
decode, a diarize net) is captured once as a `torch.cuda.CUDAGraph` and
replayed after that; the hand-written kernels B1-B5 launch inside the
graph.

A key's first call runs the body eagerly. It is the warm-up, a real tick
whose result is returned, and it does what a capture cannot: host-to-device
constants (the encoder's phase tensors), the mel constants' host copy,
cuBLAS's handles and workspaces, each kernel's shared-memory attribute and
the split-K counters of the capture stream. It runs on the cache's capture
stream, which first waits for the caller's stream and is waited for after.
The second call captures the body on that stream into a graph memory pool
of the cache's (one per device and `pool` name, shared by those graphs:
api.ASRModel keeps its ticks and its offline graphs apart, so `drop` can
free the offline ones alone) and replays it at once; every later call
replays. A key's entry counts its calls, captures and replays: a call
that did not replay ran eagerly.

What a graph holds fixed, every replay keeps fixed:
- the inputs are copied into the key's static input buffers;
- the state is the caller's, written in place by the body (JAX's
  donation; models/asr.py), or `()` for a body without one (the diarize
  nets). Before a replay every state tensor's data_ptr
  is checked against the captured ones: a state with other storage is
  captured anew (counted in `recaptures`), never replayed over stale
  addresses;
- the outputs are copied at the end of the body into static output tensors
  allocated outside the pool, so no graph's scratch memory overlaps
  another graph's outputs. They hold a replay's result until the key's
  next replay: the caller consumes them first (the engine enqueues its
  readback on the stream right after the dispatch);
- the weights and the kernels' cached constants and counters do not move
  while the model lives.

A tp group's body (one dp shard of a mesh over several devices: its
`devices`) runs its ranks on streams of their own (params.TPGroup.each):
each rank stream forks from the stream the body runs on, here the
capture stream, and joins back before every reduction and at its end, in
the warm-up and in the capture alike, so the graph holds a branch per
rank and its replay needs nothing more. The capture's pool takes every
allocation on the lead device, the rank streams' on that card included
(they belong to the capture). A rank on another card allocates from that
card's allocator, whose general cache would hand a block the graph keeps
writing at every replay to later eager work: so during a capture each
other card's allocations go into a graph pool of that card's
(torch.cuda.use_mem_pool on a torch.cuda.MemPool that the cache keeps
beside the lead's pool, one per card and pool name), which nothing
outside the captures draws from. What a capture cannot do the warm-up
does on the same rank streams: the first cross-card copies (peer access),
each kernel's shared-memory attribute per device (csrc/smem_limit.cuh),
cuBLAS's handles and workspaces per rank stream, and the split-K counters
per rank stream (ops/quant.f32_scratch).

Kernel launch counts (kernels.Kernel.launches): what the graph launches is
counted at capture, taken back, and added on every replay, so a replayed
tick counts as an eager one does.

Python's cyclic garbage collector is paused while a capture runs (and
resumed once no capture runs): a collection, which may start at any
allocation on the capturing thread, can free another graph left in a
reference cycle (a dropped model's, a diarize model's), and destroying a
graph is a call that a capture does not permit: it invalidates the
capture.

On the CPU, and with graphs off, the body runs eagerly through the same
bookkeeping (the key is recorded and its calls counted). There is no
fallback on the card: a failed capture or replay raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time

import torch

from . import kernels
from .streaming.state import state_tensors

# The key kinds of the slot operations between ticks (api.py: prime,
# reset, compact, realign); key[1] of each is the engine group's cfg.
SLOT_KEYS = ("prime", "reset", "compact", "realign")


@dataclasses.dataclass
class _Entry:
    calls: int = 0
    outputs_meta: list | None = None  # (shape, dtype) of each output
    graph: object = None
    ptrs: tuple = ()                  # the state's data_ptrs at capture
    inputs: list | None = None        # static input buffers
    outputs: list | None = None       # static output tensors
    launches: dict | None = None      # Kernel -> launches per replay
    pool: tuple = ()                  # (device, pool name)
    devices: tuple = ()               # a tp group's devices (lead first)
    captures: int = 0
    capture_seconds: float = 0.0
    pool_bytes: int = 0               # reserved memory's growth at capture
    replays: int = 0


class GraphCache:
    """One model's compiled executables: (JAX key, dp shard) -> a captured
    graph (see the module docstring). `enabled` False runs every body
    eagerly."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.entries: dict = {}
        self._pools: dict = {}    # (device, pool name) -> graph memory pool
        # ((device, pool name), other card) -> that card's MemPool
        self._card_pools: dict = {}
        self._streams: dict = {}  # device -> capture stream

    def keys(self) -> set:
        """The JAX keys called so far (the counterpart of ASRModel's
        `_fn_cache` keys in the JAX package)."""
        return {key for key, _shard in self.entries}

    def clear(self) -> None:
        """Drop every graph and the pools (ASRModel.shard: the weights
        moved)."""
        self.entries.clear()
        self._pools.clear()
        self._card_pools.clear()

    def drop(self, select) -> None:
        """Drop the graphs whose key passes `select`, and every pool that
        no graph left uses: its memory goes back to the allocator's cache
        (torch.cuda.empty_cache returns it to the device)."""
        self.entries = {k: e for k, e in self.entries.items()
                        if not select(k[0])}
        used = {e.pool for e in self.entries.values()}
        self._pools = {k: p for k, p in self._pools.items() if k in used}
        self._card_pools = {k: p for k, p in self._card_pools.items()
                            if k[0] in used}

    def stats(self, select=None) -> dict:
        """Totals over the entries whose key passes `select` (all by
        default): keys, calls, captures, recaptures (a key's captures
        after its first: states with other storage), capture seconds,
        pool bytes, replays."""
        es = [e for (key, _), e in self.entries.items()
              if select is None or select(key)]
        return {"keys": len(es), "calls": sum(e.calls for e in es),
                "captures": sum(e.captures for e in es),
                "recaptures": sum(max(e.captures - 1, 0) for e in es),
                "capture_seconds": sum(e.capture_seconds for e in es),
                "pool_bytes": sum(e.pool_bytes for e in es),
                "replays": sum(e.replays for e in es)}

    def run(self, key, shard: int, device: torch.device, body, state,
            inputs: tuple, pool: str = "", devices=()) -> tuple:
        """body(state, *inputs) -> a tuple of output tensors, the state
        written in place: eagerly (the CPU, graphs off, a key's first
        call), captured into the pool named `pool` (its second call, or a
        state with other storage), or replayed. `devices`: the shard's tp
        devices, `device` first, where the body runs over a tp group
        (the module docstring)."""
        entry = self.entries.setdefault((key, shard), _Entry())
        entry.calls += 1
        entry.devices = tuple(devices)
        if not self.enabled or device.type != "cuda":
            return tuple(body(state, *inputs))
        if entry.outputs_meta is None:
            return self._warm_up(entry, device, body, state, inputs)
        ptrs = tuple(t.data_ptr() for t in state_tensors(state))
        if entry.graph is None or entry.ptrs != ptrs:
            # the old graph goes once the new one is captured: the pool
            # must not lose its last graph before a capture into it
            entry.pool = (device, pool)
            self._capture(key, entry, device, body, state, inputs, ptrs)
        return self._replay(entry, inputs)

    def _stream(self, device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device=device)
        return self._streams[device]

    def _warm_up(self, entry, device, body, state, inputs) -> tuple:
        cur = torch.cuda.current_stream(device)
        side = self._stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            outs = tuple(body(state, *inputs))
        cur.wait_stream(side)
        for o in outs:
            o.record_stream(cur)
        entry.outputs_meta = [(o.shape, o.dtype) for o in outs]
        return outs

    def _capture(self, key, entry, device, body, state, inputs,
                 ptrs) -> None:
        cur = torch.cuda.current_stream(device)
        side = self._stream(device)
        static_in = [torch.empty_like(x) for x in inputs]
        static_out = [torch.empty(shape, dtype=dtype, device=device)
                      for shape, dtype in entry.outputs_meta]
        pool = self._pools.get(entry.pool)
        if pool is None:
            pool = self._pools[entry.pool] = torch.cuda.graph_pool_handle()
        cards = [d for d in dict.fromkeys(entry.devices) if d != device]
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        before = kernels.counts()
        reserved = {d: torch.cuda.memory_reserved(d) for d in (device, *cards)}
        t0 = time.perf_counter()
        with torch.cuda.stream(side), _gc_paused(), \
                contextlib.ExitStack() as card_pools:
            for d in cards:  # another card's allocations: its graph pool
                card_pools.enter_context(torch.cuda.use_mem_pool(
                    self._card_pool(entry.pool, d), d))
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                outs = tuple(body(state, *static_in))
                if [(o.shape, o.dtype) for o in outs] != entry.outputs_meta:
                    raise RuntimeError(
                        f"graph capture of {key}: the outputs' shapes "
                        f"changed since the warm-up")
                for dst, o in zip(static_out, outs):
                    dst.copy_(o)
            except BaseException:
                _end_failed(graph)
                self._failed(entry.pool, before)
                raise
            try:
                graph.capture_end()
            except BaseException:
                self._failed(entry.pool, before)
                raise
        cur.wait_stream(side)
        launches = _delta(before)
        kernels.add_counts(launches, -1)
        entry.capture_seconds += time.perf_counter() - t0
        entry.pool_bytes += sum(
            max(0, torch.cuda.memory_reserved(d) - n)
            for d, n in reserved.items())
        entry.captures += 1
        entry.graph, entry.ptrs, entry.launches = graph, ptrs, launches
        entry.inputs, entry.outputs = static_in, static_out

    def _card_pool(self, pool, card) -> object:
        """The graph pool on `card` (another card of a tp group) beside the
        lead's pool `pool`: a torch.cuda.MemPool made on that card, kept
        while a graph of that pool lives (drop, clear)."""
        key = (pool, card)
        if key not in self._card_pools:
            with torch.cuda.device(card):
                self._card_pools[key] = torch.cuda.MemPool()
        return self._card_pools[key]

    def _failed(self, pool, before: dict) -> None:
        """After a failed capture: its recorded launches taken back, and
        its pools left behind (a pool whose last graph is gone cannot take
        another capture)."""
        kernels.add_counts(_delta(before), -1)
        self._pools.pop(pool, None)
        self._card_pools = {k: p for k, p in self._card_pools.items()
                            if k[0] != pool}

    def _replay(self, entry, inputs) -> tuple:
        for dst, x in zip(entry.inputs, inputs):
            if x.shape != dst.shape or x.dtype != dst.dtype:
                raise ValueError(
                    f"graph replay: input {tuple(x.shape)} {x.dtype}, "
                    f"captured {tuple(dst.shape)} {dst.dtype}")
            if x is not dst:
                dst.copy_(x)
        entry.graph.replay()
        kernels.add_counts(entry.launches)
        entry.replays += 1
        return tuple(entry.outputs)


_gc_lock = threading.Lock()
_gc_pause = {"captures": 0, "was_enabled": False}


@contextlib.contextmanager
def _gc_paused():
    """Python's automatic garbage collection off while any thread's
    capture runs; on again, if it was on, once the last one ends."""
    with _gc_lock:
        if not _gc_pause["captures"]:
            _gc_pause["was_enabled"] = gc.isenabled()
            gc.disable()
        _gc_pause["captures"] += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_pause["captures"] -= 1
            if not _gc_pause["captures"] and _gc_pause["was_enabled"]:
                gc.enable()


def _delta(before: dict) -> dict:
    return {k: n - before[k] for k, n in kernels.counts().items()
            if n != before[k]}


def _end_failed(graph) -> None:
    """End a capture that raised: the stream leaves capture mode; the
    capture's own error (an invalidated capture) gives way to the
    body's."""
    try:
        graph.capture_end()
    except Exception:  # noqa: BLE001
        pass
