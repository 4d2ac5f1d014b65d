"""Multi-session streaming ASR server over TCP or a Unix socket (port of
nemotron_tpu/serving/server.py), speaking the same byte protocol
(nemotron_tpu/serving/protocol.py).

Concurrency model, as the JAX server:
  - asyncio readers move bytes only;
  - a dedicated ENGINE THREAD owns the model state and ticks back to back
    while work exists; its event batches are posted to the loop;
  - a global queued-PCM budget gives admission control, and PUSH payloads
    are split into <= 8000-sample segments for fairness;
  - fail-stop: if the engine thread dies, the listener shuts down.

Not ported yet: diarization, hot swap and the native ingest server; the
port serves right context 0 only.
"""

from __future__ import annotations

import asyncio
import json
import sys
import threading

import numpy as np

from ..shared import protocol as P
from ..streaming.engine import BatchedEngine

SUPPORTED_RIGHT_CONTEXTS = (0,)


class StreamServer:
    def __init__(self, model, batch_per_group: int = 32,
                 mem_budget: int = P.DEFAULT_MEM_BUDGET):
        self.engine = BatchedEngine(model, batch_per_group)
        self.mem_budget = mem_budget
        self.mem_used = 0
        self.mem_free = asyncio.Condition()
        self.writers: dict[int, asyncio.StreamWriter] = {}  # stream -> conn
        self.conn_streams: dict[asyncio.StreamWriter, set[int]] = {}
        self.wake = threading.Event()  # set by handlers to wake the engine
        self._engine_task: asyncio.Task | None = None
        self._stop = False
        self._queued_samples: dict[int, int] = {}

    async def _send(self, writer: asyncio.StreamWriter, frame: bytes) -> None:
        try:
            writer.write(frame)
            await writer.drain()
        except (ConnectionError, RuntimeError):
            pass  # sends to closed connections are dropped

    async def handle_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        self.conn_streams[writer] = set()
        try:
            while True:
                hdr = await reader.readexactly(P.HEADER_SIZE)
                opcode, stream_id, length = P.HEADER.unpack(hdr)
                payload = await reader.readexactly(length) if length else b""
                await self._dispatch(writer, opcode, stream_id, payload)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            # a disconnect reclaims the connection's streams and budget
            freed = 0
            for sid in list(self.conn_streams.get(writer, ())):
                self.engine.drop_stream(sid)
                self.writers.pop(sid, None)
                freed += 2 * self._queued_samples.pop(sid, 0)
            self.conn_streams.pop(writer, None)
            if freed:
                async with self.mem_free:
                    self.mem_used = max(0, self.mem_used - freed)
                    self.mem_free.notify_all()
            writer.close()

    async def _dispatch(self, writer, opcode: int, stream_id: int,
                        payload: bytes) -> None:
        if opcode == P.OP_STREAM_START:
            cfg = {}
            if payload:
                try:
                    cfg = json.loads(payload.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    cfg = {}
            if cfg.get("diarize"):
                await self._send(writer, P.pack(
                    P.OP_ERROR, 0,
                    "diarization is not supported by the torch port yet"))
                return
            try:
                rc = int(cfg.get("right_context", 0))
            except (TypeError, ValueError):
                rc = -1
            if rc not in (0, 1, 6, 13):
                await self._send(writer, P.pack(
                    P.OP_ERROR, 0,
                    f"right_context must be one of 0, 1, 6, 13 (got "
                    f"{cfg.get('right_context')!r})"))
                return
            if rc not in SUPPORTED_RIGHT_CONTEXTS:
                await self._send(writer, P.pack(
                    P.OP_ERROR, 0,
                    f"right_context {rc} is not supported by the torch port "
                    "yet (it runs right_context 0)"))
                return
            try:
                sid = self.engine.start_stream(right_context=rc,
                                               lang=cfg.get("lang"))
            except RuntimeError as e:
                await self._send(writer, P.pack(P.OP_ERROR, 0, str(e)))
                return
            self.writers[sid] = writer
            self.conn_streams[writer].add(sid)
            self._queued_samples[sid] = 0
            await self._send(writer, P.pack_json(P.OP_STARTED, sid, {"id": sid}))

        elif opcode == P.OP_PUSH:
            if stream_id not in self.conn_streams.get(writer, ()):
                return  # DATA for a stream this connection does not own
            audio = np.frombuffer(payload, dtype="<i2")
            n = len(audio)
            async with self.mem_free:  # admission control
                while self.mem_used + 2 * n > self.mem_budget:
                    await self.mem_free.wait()
                self.mem_used += 2 * n
            # bill before handing to the engine: the engine thread may
            # consume the samples at once
            self._queued_samples[stream_id] = (
                self._queued_samples.get(stream_id, 0) + n)
            for off in range(0, n, P.MAX_SEGMENT_SAMPLES):
                self.engine.push_audio(
                    stream_id, audio[off:off + P.MAX_SEGMENT_SAMPLES])
            self.wake.set()
            await self._send(writer, P.pack_json(
                P.OP_ACK, stream_id,
                {"queued_samples": self._queued_samples[stream_id]}))

        elif opcode == P.OP_STREAM_END:
            if stream_id in self.conn_streams.get(writer, ()):
                self.engine.end_stream(stream_id)
                self.wake.set()

        elif opcode == P.OP_SET_LANG:
            if stream_id not in self.conn_streams.get(writer, ()):
                await self._send(writer, P.pack(
                    P.OP_ERROR, stream_id, f"unknown stream {stream_id}"))
                return
            lang = payload.decode("utf-8", errors="replace")
            try:
                idx = self.engine.set_language(stream_id, lang)
            except KeyError:
                await self._send(writer, P.pack(
                    P.OP_ERROR, stream_id, f"stream {stream_id} already ended"))
                return
            if idx is None:
                await self._send(writer, P.pack(
                    P.OP_ERROR, stream_id, f"unknown language '{lang}'"))
            else:
                await self._send(writer, P.pack_json(
                    P.OP_LANG_SET, stream_id,
                    {"id": stream_id, "lang": lang, "index": idx}))
        else:
            await self._send(writer, P.pack(
                P.OP_ERROR, stream_id, f"bad opcode {opcode}"))

    def _engine_thread(self, loop: asyncio.AbstractEventLoop,
                       out_q: asyncio.Queue) -> None:
        """Tick loop on its own thread: back-to-back ticks while work exists
        (woken by the handlers, plus a 50 ms poll for readback tails)."""
        try:
            while not self._stop:
                self.wake.wait(timeout=0.05)
                self.wake.clear()
                more = True
                while more and not self._stop:
                    events, more = self.engine.tick()
                    consumed = self.engine.drain_consumed()
                    if events or consumed:
                        try:
                            loop.call_soon_threadsafe(out_q.put_nowait,
                                                      (events, consumed))
                        except RuntimeError:  # loop closed: shutting down
                            self._stop = True
                            return
        except BaseException:
            import traceback

            traceback.print_exc()
            self._stop = True
            try:  # fail-stop sentinel: take the listener down
                loop.call_soon_threadsafe(out_q.put_nowait, None)
            except RuntimeError:
                pass
            raise

    async def engine_loop(self) -> None:
        loop = asyncio.get_running_loop()
        out_q: asyncio.Queue = asyncio.Queue()
        thread = threading.Thread(target=self._engine_thread,
                                  args=(loop, out_q), daemon=True,
                                  name="engine-tick")
        thread.start()
        try:
            while True:
                item = await out_q.get()
                if item is None:
                    raise RuntimeError(
                        "engine thread died; shutting the server down")
                events, consumed = item
                freed = 0
                for sid, n in consumed.items():  # budget release
                    have = self._queued_samples.get(sid, 0)
                    take = min(have, n)
                    self._queued_samples[sid] = have - take
                    freed += 2 * take
                touched: set[asyncio.StreamWriter] = set()
                for ev in events:
                    w = self.writers.get(ev.stream_id)
                    if ev.kind == "text" and w is not None and ev.text:
                        try:
                            w.write(P.pack(P.OP_TEXT, ev.stream_id, ev.text))
                            touched.add(w)
                        except (ConnectionError, RuntimeError):
                            pass
                    elif ev.kind == "ended":
                        if w is not None:
                            try:
                                w.write(P.pack(P.OP_ENDED, ev.stream_id,
                                               ev.text))
                                touched.add(w)
                            except (ConnectionError, RuntimeError):
                                pass
                            self.conn_streams.get(w, set()).discard(
                                ev.stream_id)
                        self.writers.pop(ev.stream_id, None)
                        freed += 2 * self._queued_samples.pop(ev.stream_id, 0)
                for w in touched:
                    try:
                        await w.drain()
                    except (ConnectionError, RuntimeError):
                        pass
                if freed:
                    async with self.mem_free:
                        self.mem_used = max(0, self.mem_used - freed)
                        self.mem_free.notify_all()
        finally:
            self._stop = True
            self.wake.set()
            await asyncio.to_thread(thread.join, 5.0)

    async def start(self, host: str | None = None, port: int | None = None,
                    unix_path: str | None = None) -> asyncio.AbstractServer:
        """Start the engine and the listener; returns the asyncio server
        (port 0 picks a free port: server.sockets[0].getsockname())."""
        self._engine_task = asyncio.create_task(self.engine_loop())
        if unix_path:
            return await asyncio.start_unix_server(self.handle_conn,
                                                   path=unix_path)
        return await asyncio.start_server(self.handle_conn, host or "127.0.0.1",
                                          8090 if port is None else port)

    async def stop(self, server: asyncio.AbstractServer) -> None:
        server.close()
        await server.wait_closed()
        if self._engine_task is not None:
            self._engine_task.cancel()
            try:
                await self._engine_task
            except asyncio.CancelledError:
                pass

    async def serve(self, host: str | None = None, port: int | None = None,
                    unix_path: str | None = None) -> None:
        server = await self.start(host, port, unix_path)
        where = unix_path or "%s:%d" % server.sockets[0].getsockname()[:2]
        print(f"listening on {where} ({self.engine.model.backend_name})",
              file=sys.stderr)
        async with server:
            serve_task = asyncio.create_task(server.serve_forever())
            done, _ = await asyncio.wait(
                {serve_task, self._engine_task},
                return_when=asyncio.FIRST_COMPLETED)
            if self._engine_task in done:
                serve_task.cancel()
                self._engine_task.result()  # re-raise the engine failure


# Options of the JAX server that the port refuses until it runs them.
_NOT_PORTED = (
    ("--native", {"action": "store_true"}, "the native ingest server"),
    ("--diarize", {"default": None, "metavar": "DIARIZE_GGUF"},
     "diarization"),
    ("--dp", {"type": int, "default": 1}, "multi-GPU serving"),
    ("--tp", {"type": int, "default": 1}, "multi-GPU serving"),
)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(
        description="nemotron_tpu_torch streaming server (PyTorch / CUDA)")
    ap.add_argument("model", help="model.gguf path, or 'random' for a random "
                                  "full-size model (benchmarks)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--unix", default=None, help="unix socket path")
    ap.add_argument("--batch", type=int, default=32,
                    help="stream slots per latency group")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 weights, activations and K/V caches")
    ap.add_argument("--quantized", action="store_true",
                    help="keep a GGUF's Q8_0 / Q4_0 encoder matrices "
                         "quantized (dequantized inside the CUDA kernels "
                         "B4 / B5); 'random' ignores it")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 attention K/V caches with per-frame scales "
                         "(read directly by the attention kernel B1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--mem-budget", type=int, default=P.DEFAULT_MEM_BUDGET,
                    help="global queued-PCM admission budget in bytes")
    ap.add_argument("--blank-bias", type=float, default=0.0,
                    help="benchmark plumbing: add this to the joint blank "
                         "logit bias (random weights emit ~nothing useful "
                         "without it)")
    ap.add_argument("--prewarm", action="store_true",
                    help="run every tick variant once before serving")
    for flag, kw, what in _NOT_PORTED:
        ap.add_argument(flag, help=f"not supported by the torch port yet "
                                   f"({what})", **kw)
    args = ap.parse_args(argv)
    for flag, kw, what in _NOT_PORTED:
        if getattr(args, flag[2:].replace("-", "_")) != ap.get_default(
                flag[2:].replace("-", "_")):
            ap.error(f"{flag}: {what} is not supported by the torch port "
                     "yet (see ROADMAP.md)")

    from ..api import ASRModel

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    device = torch.device(args.device)
    if args.model == "random":
        model = ASRModel.random(dtype=dtype, device=device,
                                kv_int8=args.kv_int8)
    else:
        model = ASRModel.from_gguf(args.model, dtype=dtype, device=device,
                                   keep_quantized=args.quantized,
                                   kv_int8=args.kv_int8)
    if args.blank_bias:
        model.params.joint.out_b[model.hp.blank_id] += args.blank_bias

    srv = StreamServer(model, batch_per_group=args.batch,
                       mem_budget=args.mem_budget)
    if args.prewarm:
        print("prewarming tick variants...", file=sys.stderr)
        srv.engine.prewarm()
    asyncio.run(srv.serve(args.host, args.port, args.unix))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
