"""Streaming server with the native ingest path (port of
nemotron_tpu/serving/native_server.py).

The same wire protocol and observable behaviour as serving/server.py, in
another runtime shape: ONE Python thread runs control and the engine's
ticks, while all socket I/O, framing, PCM staging, ACKs and the admission
budget live in a C++ epoll thread (csrc/host/ingest_server.cpp, built with
g++ into the package's _build/) that never takes the GIL. Audio enters
Python once per tick, as the packed [B, k * shift] int16 block
(EngineGroup's `source`). A library that does not build raises with the
compiler's message: nothing falls back to the asyncio server.

Not supported here, as in the JAX package: diarization (the native path
has no per-stream event hook), live-stream migration and hot swap.
"""

from __future__ import annotations

import json
import sys
import time

from ..streaming.engine import BatchedEngine
from ..utils.trace import Totals
from . import protocol as P
from .ingest import (EV_DROP, EV_END, EV_SET_LANG, EV_START, NativeIngest,
                     require_native_ingest)
from .server import SUPPORTED_RIGHT_CONTEXTS


class NativeStreamServer:
    def __init__(self, model, batch_per_group: int = 32,
                 mem_budget: int = P.DEFAULT_MEM_BUDGET, **engine_kw):
        """engine_kw: BatchedEngine's flow arguments (gated_realign,
        phase_timers, readback_depth, max_tick_chunks)."""
        self.model = model
        self.batch = batch_per_group
        self.mem_budget = mem_budget
        self.engine_kw = engine_kw
        self.ingest: NativeIngest | None = None
        self.engine: BatchedEngine | None = None
        self.conn_of: dict[int, int] = {}  # stream_id -> conn id
        self._stop = False
        # the serving loop's spans (utils/trace.py): server.wait,
        # .control, .tick (BatchedEngine.tick(), the groups' engine.tick
        # spans under it) and .deliver
        self.spans = Totals()

    @property
    def loop_seconds(self) -> dict:
        """Host seconds of the serving loop: waiting for work, control,
        ticks and delivery."""
        secs = self.spans.seconds
        return {k: secs.get("server." + k, 0.0)
                for k in ("wait", "control", "tick", "deliver")}

    def start(self, host: str | None = None, port: int | None = None,
              unix_path: str | None = None) -> int:
        """Build the library, bind and start the native I/O thread; returns
        the bound TCP port. Raises RuntimeError if the library is
        unavailable."""
        require_native_ingest()
        self.ingest = NativeIngest(host=host or "127.0.0.1",
                                   port=port or 0, unix_path=unix_path,
                                   budget_bytes=self.mem_budget)
        self.engine = BatchedEngine(self.model, self.batch,
                                    source=self.ingest, **self.engine_kw)
        return self.ingest.port

    def stop(self) -> None:
        self._stop = True

    def _handle_control(self) -> None:
        for typ, conn, sid, payload in self.ingest.poll_control():
            if typ == EV_START:
                cfg = {}
                if payload:
                    try:
                        cfg = json.loads(payload.decode("utf-8"))
                    except (ValueError, UnicodeDecodeError):
                        cfg = {}
                try:
                    rc = int(cfg.get("right_context", 0))
                except (TypeError, ValueError):
                    rc = -1
                if rc not in SUPPORTED_RIGHT_CONTEXTS:
                    self.ingest.send(
                        conn, P.OP_ERROR, 0,
                        f"right_context must be one of 0, 1, 6, 13 (got "
                        f"{cfg.get('right_context')!r})")
                    continue
                if cfg.get("diarize"):
                    self.ingest.send(
                        conn, P.OP_ERROR, 0,
                        "diarization not enabled (start the server with "
                        "--diarize <diarize.gguf>)")
                    continue
                try:
                    new_sid = self.engine.start_stream(
                        right_context=rc, lang=cfg.get("lang"))
                except RuntimeError as e:
                    self.ingest.send(conn, P.OP_ERROR, 0, str(e))
                    continue
                # register BEFORE the STARTED reply: the client may PUSH the
                # moment it learns the id
                self.ingest.register_stream(conn, new_sid)
                self.conn_of[new_sid] = conn
                self.ingest.send(conn, P.OP_STARTED, new_sid,
                                 json.dumps({"id": new_sid}))
            elif typ == EV_END:
                if sid in self.conn_of:
                    self.engine.end_stream(sid)
            elif typ == EV_SET_LANG:
                lang = payload.decode("utf-8", errors="replace")
                if sid not in self.conn_of:
                    continue
                try:
                    idx = self.engine.set_language(sid, lang)
                except KeyError:
                    self.ingest.send(conn, P.OP_ERROR, sid,
                                     f"stream {sid} already ended")
                    continue
                if idx is None:
                    self.ingest.send(conn, P.OP_ERROR, sid,
                                     f"unknown language '{lang}'")
                else:
                    self.ingest.send(
                        conn, P.OP_LANG_SET, sid,
                        json.dumps({"id": sid, "lang": lang, "index": idx}))
            elif typ == EV_DROP:
                # the connection died: reclaim the slot (the native layer
                # already freed the ring and the budget)
                if sid in self.conn_of:
                    self.engine.drop_stream(sid)
                    self.conn_of.pop(sid, None)

    def _deliver(self, events) -> None:
        for ev in events:
            conn = self.conn_of.get(ev.stream_id)
            if ev.kind == "text":
                if conn is not None and ev.text:
                    self.ingest.send(conn, P.OP_TEXT, ev.stream_id, ev.text)
            elif ev.kind == "ended":
                if conn is not None:
                    self.ingest.send(conn, P.OP_ENDED, ev.stream_id, ev.text)
                self.conn_of.pop(ev.stream_id, None)
                self.ingest.drop_stream(ev.stream_id)

    def serve_forever(self) -> None:
        """Control and tick loop on the calling thread (the process's only
        Python thread)."""
        if self.ingest is None:
            raise RuntimeError("call start() first")
        span = self.spans.span
        last_stats = time.monotonic()
        try:
            while not self._stop:
                with span("server.wait"):  # GIL-free, until work or timeout
                    self.ingest.wait(50)
                with span("server.control"):
                    self._handle_control()
                more = True
                while more and not self._stop:
                    with span("server.tick"):
                        events, more = self.engine.tick()
                    with span("server.deliver"):
                        self._deliver(events)
                    # keep control latency low during back-to-back ticks
                    with span("server.control"):
                        self._handle_control()
                if time.monotonic() - last_stats > 10.0:
                    last_stats = time.monotonic()
                    print(f"[stats] {json.dumps(self.engine.stats())} loop "
                          + " ".join(f"{k}={v:.1f}" for k, v
                                     in self.loop_seconds.items()),
                          file=sys.stderr)
        finally:
            self.ingest.stop()
