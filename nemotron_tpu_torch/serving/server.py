"""Multi-session streaming ASR server over TCP or a Unix socket (port of
nemotron_tpu/serving/server.py), speaking the same byte protocol
(nemotron_tpu/serving/protocol.py).

Concurrency model, as the JAX server:
  - asyncio readers move bytes only;
  - a dedicated ENGINE THREAD owns the model state and ticks back to back
    while work exists; its event batches are posted to the loop;
  - a global queued-PCM budget gives admission control, and PUSH payloads
    are split into <= 8000-sample segments for fairness;
  - fail-stop: if the engine thread dies, the listener shuts down;
  - `hot_swap` replaces the model under live streams: every stream is
    exported from the engine and imported, with its id, into a fresh
    engine on the new model, while stream opcodes wait on a gate;
  - per-stream diarization (a server given `diarize_params`, a stream that
    STARTs with {"diarize": true}): the pipelines run on the engine thread,
    their word JSONL goes out as OP_DIARIZE frames, and NME-SC runs on a
    single worker thread at the stream's end, its result frame sent ahead
    of the stream's OP_ENDED.

The engine's arguments (`gated_realign`, `phase_timers`, `readback_depth`,
`max_tick_chunks`) come from NEMOTRON_TPU_GATED_REALIGN,
NEMOTRON_TPU_PHASE_TIMERS, NEMOTRON_TPU_READBACK_DEPTH and
NEMOTRON_TPU_MAX_TICK_CHUNKS in main(), as the JAX engine reads them, and
NEMOTRON_TPU_CONFIDENCE selects ASRModel(confidence=True). `--native`
serves through serving/native_server.py (the C++ ingest thread). `--dp` /
`--tp` serve one engine over a device mesh (parallel/mesh.py): the first
dp x tp CUDA cards, or ["cpu"] * (dp x tp) with `--device cpu`.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import json
import os
import sys
import threading
import time

import numpy as np

from . import protocol as P
from ..streaming.engine import BatchedEngine
from ..streaming.state import state_leaves

SUPPORTED_RIGHT_CONTEXTS = (0, 1, 6, 13)


class StreamServer:
    def __init__(self, model, batch_per_group: int = 32,
                 mem_budget: int = P.DEFAULT_MEM_BUDGET,
                 diarize_params=None, **engine_kw):
        """engine_kw: BatchedEngine's flow arguments (gated_realign,
        phase_timers, readback_depth, max_tick_chunks). diarize_params
        (diarize.params.load_diarize_model) enables per-stream
        diarization."""
        self.engine_kw = engine_kw
        self.engine = BatchedEngine(model, batch_per_group, **engine_kw)
        self.mem_budget = mem_budget
        self.mem_used = 0
        self.mem_free = asyncio.Condition()
        self.writers: dict[int, asyncio.StreamWriter] = {}  # stream -> conn
        self.conn_streams: dict[asyncio.StreamWriter, set[int]] = {}
        self.wake = threading.Event()  # set by handlers to wake the engine
        self._engine_task: asyncio.Task | None = None
        self._stop = False
        self._queued_samples: dict[int, int] = {}
        # hot swap (see hot_swap): while one is in flight, stream opcodes
        # wait on this gate, so no PUSH lands between a stream's export
        # from the old engine and the new engine taking over
        self._swap_gate: asyncio.Event | None = None
        self._pending_swap: tuple | None = None  # (new model, Future)
        # the last swap's streams, host seconds of its export and import
        # loops, and the bytes of its snapshots' state and staged audio
        self.last_swap: dict = {}
        # diarization: sid -> {"pipeline", "audio": deque of staged PCM}.
        # The pipelines run on the engine thread; the handlers only append
        # PCM to the deque. The staged copy is billed against the budget
        # too (2 bytes a sample), released as _diarize_step drains it.
        self.diarize_params = diarize_params
        self._diar: dict[int, dict] = {}
        self._diar_staged: dict[int, int] = {}
        # NME-SC at a stream's end runs on this single worker while ticks
        # go on; the stream's 'ended' event is held until its result frame
        # is out (_diarize_poll)
        self._diar_exec: concurrent.futures.ThreadPoolExecutor | None = None
        self._diar_pending: list = []  # (sid, Future, held ended events)

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
                self._diar.pop(sid, None)
                freed += 2 * self._queued_samples.pop(sid, 0)
                freed += 2 * self._diar_staged.pop(sid, 0)
            self.conn_streams.pop(writer, None)
            if freed:
                async with self.mem_free:
                    self.mem_used = max(0, self.mem_used - freed)
                    self.mem_free.notify_all()
            writer.close()

    async def _dispatch(self, writer, opcode: int, stream_id: int,
                        payload: bytes) -> None:
        if self._swap_gate is not None and opcode in (
                P.OP_STREAM_START, P.OP_PUSH, P.OP_STREAM_END, P.OP_SET_LANG):
            await self._swap_gate.wait()  # clients see delayed replies
        if opcode == P.OP_STREAM_START:
            cfg = {}
            if payload:
                try:
                    cfg = json.loads(payload.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    cfg = {}
            want_diar = bool(cfg.get("diarize"))
            if want_diar and self.diarize_params is None:
                await self._send(writer, P.pack(
                    P.OP_ERROR, 0,
                    "diarization not enabled (start the server with "
                    "--diarize <diarize.gguf>)"))
                return
            try:
                rc = int(cfg.get("right_context", 0))
            except (TypeError, ValueError):
                rc = -1
            if rc not in SUPPORTED_RIGHT_CONTEXTS:
                await self._send(writer, P.pack(
                    P.OP_ERROR, 0,
                    f"right_context must be one of 0, 1, 6, 13 (got "
                    f"{cfg.get('right_context')!r})"))
                return
            try:
                sid = self.engine.start_stream(right_context=rc,
                                               lang=cfg.get("lang"))
            except RuntimeError as e:
                await self._send(writer, P.pack(P.OP_ERROR, 0, str(e)))
                return
            if want_diar:
                from ..diarize.pipeline import DiarizePipeline

                self._diar[sid] = {
                    "pipeline": DiarizePipeline(
                        self.diarize_params,
                        num_speakers=int(cfg.get("num_speakers", -1))),
                    "audio": collections.deque(),
                }
                self._diar_staged[sid] = 0
            self.writers[sid] = writer
            self.conn_streams[writer].add(sid)
            self._queued_samples[sid] = 0
            await self._send(writer, P.pack_json(P.OP_STARTED, sid, {"id": sid}))

        elif opcode == P.OP_PUSH:
            if stream_id not in self.conn_streams.get(writer, ()):
                return  # DATA for a stream this connection does not own
            audio = np.frombuffer(payload, dtype="<i2")
            n = len(audio)
            # admission control; a diarize stream stages a second copy of
            # the PCM for its pipeline and is billed double
            bill = 4 * n if stream_id in self._diar else 2 * n
            async with self.mem_free:
                while self.mem_used + bill > self.mem_budget:
                    await self.mem_free.wait()
                self.mem_used += bill
            # bill before handing to the engine: the engine thread may
            # consume the samples at once
            self._queued_samples[stream_id] = (
                self._queued_samples.get(stream_id, 0) + n)
            for off in range(0, n, P.MAX_SEGMENT_SAMPLES):
                self.engine.push_audio(
                    stream_id, audio[off:off + P.MAX_SEGMENT_SAMPLES])
            d = self._diar.get(stream_id)
            if d is not None:
                d["audio"].append(audio)
                self._diar_staged[stream_id] = (
                    self._diar_staged.get(stream_id, 0) + n)
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

    def _diarize_step(self, events) -> tuple[list[tuple[int, str]],
                                             dict[int, int]]:
        """Advance the diarization pipelines (engine thread: their nets run
        on the device). Drains each diarize stream's staged PCM, feeds this
        tick's text events as words, and returns ((stream id, JSON line)
        frames, the drained samples per stream for the budget): word JSONL
        as words complete; at a stream's end its tail embeddings here and
        NME-SC on the worker, the 'ended' event held back (taken out of
        `events`) until _diarize_poll delivers the result frame."""
        frames: list[tuple[int, str]] = []
        drained: dict[int, int] = {}
        for sid, d in list(self._diar.items()):
            p = d["pipeline"]
            q = d["audio"]
            while q:
                a = q.popleft()
                drained[sid] = drained.get(sid, 0) + len(a)
                p.push_audio(a.astype(np.float32) / 32768.0)
            for ev in events:
                if ev.stream_id == sid and ev.text:
                    # words are stamped at the decode position the engine
                    # reports, not at the staged audio's end: a client ahead
                    # of real time would pin every word to its file's end
                    at = ev.at_sec if ev.at_sec >= 0.0 \
                        else p.total_samples / 16000.0
                    p.push_text(ev.text, at, conf=ev.conf)
            frames.extend((sid, line) for line in p.drain_json())
            held = [ev for ev in events
                    if ev.stream_id == sid and ev.kind == "ended"]
            if held:
                p.finalize_embeddings()
                frames.extend((sid, line) for line in p.drain_json())
                if self._diar_exec is None:
                    self._diar_exec = concurrent.futures.ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="diar-cluster")
                fut = self._diar_exec.submit(p.finalize_cluster)
                events[:] = [ev for ev in events if ev not in held]
                self._diar_pending.append((sid, fut, held))
                # the loop's disconnect handler pops concurrently
                self._diar.pop(sid, None)
        return frames, drained

    def _diarize_poll(self) -> tuple[list[tuple[int, str]], list]:
        """Collect finished clusterings (engine thread): (result frames, the
        held 'ended' events to deliver after them)."""
        frames: list[tuple[int, str]] = []
        events: list = []
        if not self._diar_pending:
            return frames, events
        still = []
        for sid, fut, held in self._diar_pending:
            if not fut.done():
                still.append((sid, fut, held))
                continue
            try:
                res = fut.result()
                frames.append((sid, json.dumps({
                    "type": "result",
                    "speaker_text": res.speaker_text,
                    "rttm": res.rttm,
                    "n_speakers": res.n_speakers,
                })))
            except Exception:  # noqa: BLE001 -- one stream's failure must
                import traceback  # not fail-stop the server

                traceback.print_exc()
                frames.append((sid, json.dumps({
                    "type": "result", "error": "diarization finalize failed",
                    "speaker_text": "", "rttm": "", "n_speakers": 0,
                })))
            events.extend(held)
        self._diar_pending = still
        return frames, events

    def _engine_step(self, engine) -> tuple[tuple, bool]:
        """One engine tick with its diarization work: returns ((events,
        consumed, diarize frames, diarize drained), more)."""
        events, more = engine.tick()
        consumed = engine.drain_consumed()
        frames, drained = (self._diarize_step(events) if self._diar
                           else ([], {}))
        done_frames, done_events = self._diarize_poll()
        frames.extend(done_frames)
        events.extend(done_events)
        return (events, consumed, frames, drained), more

    async def hot_swap(self, new_model) -> int:
        """Replace the serving model under live streams. Every stream is
        exported from the current engine and imported into a fresh
        BatchedEngine on `new_model` (same batch and flow) with its stream
        id, so clients go on as before; with the same weights the
        transcripts are those of no swap, byte for byte, and under new
        weights the carried caches are the old model's (an operator's
        choice). Stream opcodes wait on a gate meanwhile, so no audio is
        lost. Returns the number of migrated streams. A native-ingest engine
        refuses (NotImplementedError), as in the JAX package."""
        if self.engine.source is not None:
            raise NotImplementedError(
                "hot swap is not supported on native-ingest engines")
        if self._swap_gate is not None:
            raise RuntimeError("a hot swap is already in progress")
        self._swap_gate = asyncio.Event()
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._pending_swap = (new_model, fut)
        self.wake.set()
        try:
            return await asyncio.wrap_future(fut)
        finally:
            gate, self._swap_gate = self._swap_gate, None
            gate.set()  # release the parked opcodes

    def _maybe_swap(self, loop, out_q) -> None:
        """Engine thread: run a queued hot swap between ticks."""
        swap, self._pending_swap = self._pending_swap, None
        if swap is None:
            return
        new_model, fut = swap
        try:
            fut.set_result(self._do_swap(new_model, loop, out_q))
        except BaseException as e:  # surfaced to the hot_swap caller
            fut.set_exception(e)

    def _do_swap(self, new_model, loop, out_q) -> int:
        """Export every live stream from the current engine (ticking it
        until its finalizing streams have ended, 200 ticks at most), import
        each into a fresh engine on new_model with the same id, then switch
        self.engine and release the old engine's consumed budget. Runs on
        the engine thread, which owns every device mutation."""
        old = self.engine
        new = BatchedEngine(new_model, old.batch, **self.engine_kw)

        def post(item):
            if any(item):
                try:
                    loop.call_soon_threadsafe(out_q.put_nowait, item)
                except RuntimeError:
                    pass  # loop closed: shutting down

        snaps: dict[int, dict] = {}
        t0 = time.perf_counter()
        for _ in range(200):
            futs = {}
            for sid in [s for s in list(old._route) if s not in snaps]:
                try:
                    futs[sid] = old.request_export(sid)
                except KeyError:
                    continue  # ended meanwhile
            item, more = self._engine_step(old)
            post(item)
            for sid, f in futs.items():
                if f.done() and f.exception() is None:
                    snaps[sid] = f.result()
            if not old._route and not more:
                break
        else:
            raise RuntimeError("hot swap: old engine did not drain")

        t1 = time.perf_counter()
        im_futs = {sid: new.request_import(snap, stream_id=sid,
                                           trust_model=True)
                   for sid, snap in snaps.items()}
        for _ in range(200):
            if all(f.done() for f in im_futs.values()):
                break
            post(self._engine_step(new)[0])
        for sid, f in im_futs.items():
            got = f.result()  # raises on a failed install
            if got != sid:
                raise RuntimeError(f"import renumbered stream {sid} -> {got}")
        self.engine = new
        post(([], old.drain_consumed(), [], {}))  # the old engine's last
        self.last_swap = {
            "streams": len(snaps), "export_seconds": t1 - t0,
            "import_seconds": time.perf_counter() - t1,
            "snapshot_bytes": sum(
                sum(np.asarray(x).nbytes for x in state_leaves(s["state"]))
                + np.asarray(s["stage"]).nbytes for s in snaps.values())}
        return len(snaps)

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
                    self._maybe_swap(loop, out_q)
                    item, more = self._engine_step(self.engine)
                    if any(item):
                        try:
                            loop.call_soon_threadsafe(out_q.put_nowait, item)
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
                events, consumed, diar_frames, diar_drained = item
                freed = 0
                for sid, n in consumed.items():  # budget release
                    have = self._queued_samples.get(sid, 0)
                    take = min(have, n)
                    self._queued_samples[sid] = have - take
                    freed += 2 * take
                for sid, n in diar_drained.items():  # the diarize copy
                    have = self._diar_staged.get(sid, 0)
                    take = min(have, n)
                    self._diar_staged[sid] = have - take
                    freed += 2 * take
                touched: set[asyncio.StreamWriter] = set()
                # diarize frames first: a stream's result frame goes out
                # ahead of its OP_ENDED
                for sid, line in diar_frames:
                    w = self.writers.get(sid)
                    if w is not None:
                        try:
                            w.write(P.pack(P.OP_DIARIZE, sid, line))
                            touched.add(w)
                        except (ConnectionError, RuntimeError):
                            pass
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
                        freed += 2 * self._diar_staged.pop(ev.stream_id, 0)
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
            if self._diar_exec is not None:
                self._diar_exec.shutdown(wait=False)

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


def build_parser():
    import argparse

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
    ap.add_argument("--native", action="store_true",
                    help="serve through the C++ ingest thread "
                         "(serving/native_server.py): the same wire "
                         "protocol, no Python socket handling")
    ap.add_argument("--diarize", default=None, metavar="DIARIZE_GGUF",
                    help="enable per-stream diarization: streams that START "
                         "with {\"diarize\": true} get OP_DIARIZE word "
                         "JSONL frames and a final result frame. Not "
                         "supported with --native.")
    ap.add_argument("--dp", type=int, default=1,
                    help="split the stream batch over this many devices "
                         "(one engine ticks dp x tp devices; --batch must "
                         "divide by --dp)")
    ap.add_argument("--tp", type=int, default=1,
                    help="additionally split the large layer matrices "
                         "(Megatron-style) over this many devices per dp "
                         "shard")
    return ap


def parse_args(argv=None):
    """The parsed options, with the refusals made before any model loads:
    --diarize with --native (as in the JAX package), a mesh axis below 1,
    and a batch that dp does not divide (the JAX package's ValueError at
    its first stream state, here before the load)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.native and args.diarize:
        ap.error("--diarize is not supported with --native (the native "
                 "ingest path has no per-stream event hook)")
    if args.dp < 1 or args.tp < 1:
        ap.error("--dp and --tp must be at least 1")
    if args.batch % args.dp:
        ap.error(f"stream batch {args.batch} must be divisible by the "
                 f"mesh's dp={args.dp}")
    return args


def load_model_from_args(args):
    """The model main() serves: loaded (or random) on --device, with the
    blank bias, then placed on a dp x tp mesh where either is above 1."""
    import torch

    from ..api import ASRModel

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    device = torch.device(args.device)
    env = os.environ.get
    # the JAX package's switches of the fused attention block (kernel B3)
    # and of per-token confidences, as the model's arguments here
    attn_block = env("NEMOTRON_TPU_PALLAS_ATTN_BLOCK", "0") == "1"
    confidence = env("NEMOTRON_TPU_CONFIDENCE", "") == "1"
    if args.model == "random":
        model = ASRModel.random(dtype=dtype, device=device,
                                kv_int8=args.kv_int8, attn_block=attn_block,
                                confidence=confidence)
    else:
        model = ASRModel.from_gguf(args.model, dtype=dtype, device=device,
                                   keep_quantized=args.quantized,
                                   kv_int8=args.kv_int8,
                                   attn_block=attn_block,
                                   confidence=confidence)
    if args.blank_bias:
        model.params.joint.out_b[model.hp.blank_id] += args.blank_bias
    if args.dp * args.tp > 1:
        from ..parallel.mesh import make_mesh

        n = args.dp * args.tp
        model.shard(make_mesh(args.dp, args.tp, devices=(
            [device] * n if device.type == "cpu" else None)))
        print(f"mesh serving: dp={args.dp} x tp={args.tp} "
              f"({model.backend_name})", file=sys.stderr)
    return model


def main(argv=None) -> int:
    args = parse_args(argv)
    model = load_model_from_args(args)
    device = model.device
    env = os.environ.get

    # the JAX engine's switches, as the engine's arguments here
    engine_kw = dict(
        gated_realign=env("NEMOTRON_TPU_GATED_REALIGN", "1") == "1",
        phase_timers=env("NEMOTRON_TPU_PHASE_TIMERS", "") == "1",
        readback_depth=int(env("NEMOTRON_TPU_READBACK_DEPTH", "2")),
        max_tick_chunks=int(env("NEMOTRON_TPU_MAX_TICK_CHUNKS", "8")))

    if args.native:
        from .native_server import NativeStreamServer

        nsrv = NativeStreamServer(model, batch_per_group=args.batch,
                                  mem_budget=args.mem_budget, **engine_kw)
        port = nsrv.start(args.host, args.port, args.unix)
        if args.prewarm:  # early connects queue until serve_forever
            print("prewarming tick variants...", file=sys.stderr)
            nsrv.engine.prewarm()
        print(f"listening on {args.unix or f'{args.host}:{port}'} (native, "
              f"{model.backend_name})", file=sys.stderr)
        nsrv.serve_forever()
        return 0

    diarize_params = None
    if args.diarize:
        from ..diarize.params import load_diarize_model

        diarize_params = load_diarize_model(args.diarize, device=device)
        print(f"diarization enabled ({args.diarize})", file=sys.stderr)

    srv = StreamServer(model, batch_per_group=args.batch,
                       mem_budget=args.mem_budget,
                       diarize_params=diarize_params, **engine_kw)
    if args.prewarm:
        print("prewarming tick variants...", file=sys.stderr)
        srv.engine.prewarm()
    asyncio.run(srv.serve(args.host, args.port, args.unix))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
