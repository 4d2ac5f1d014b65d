"""Scale-out across cards/hosts: replica launcher + client-side stream router
(port of nemotron_tpu/serving/replicas.py, the same code apart from the
server module it launches, SERVER_MODULE).

Design: streaming ASR state is strictly per-stream, so the scale-out unit
is a whole server REPLICA — one engine + one card (or one host) each —
behind the same multiplexed wire protocol, with streams routed to replicas
at start time. No cross-replica communication exists or is needed:
replica-per-host; parallelism within a replica lives in parallel/mesh.py's
dp x tp.

Two pieces:

  ReplicaSet     launcher: spawns N `python -m SERVER_MODULE` subprocesses
                 (one per card/host), waits for their listen lines,
                 terminates them on close. Per-replica env overrides let
                 each pin its own card (CUDA_VISIBLE_DEVICES).

  RoutedClient   client-side router: connects to every replica, assigns each
                 new stream to the replica with the fewest live streams
                 (least-loaded; ties broken round-robin), and demultiplexes
                 replies per stream. Stream ids are (replica, sid) pairs
                 flattened into opaque handles, so callers see one logical
                 server.

The reference has no analogue (single-process, single-GPU server); the
equivalent operational pattern for it would be an external load balancer.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time

import numpy as np

from . import protocol as P
from .client import StreamClient

# the server each replica runs
SERVER_MODULE = "nemotron_tpu_torch.serving.server"


class ReplicaSet:
    """Launch and own N server replicas as subprocesses."""

    def __init__(self, model_path: str, n_replicas: int,
                 host: str = "127.0.0.1", port_base: int = 8090,
                 batch_per_group: int = 32, native: bool = False,
                 extra_args: list[str] | None = None,
                 env_per_replica: list[dict] | None = None):
        self.addrs: list[tuple[str, int]] = []
        self.procs: list[subprocess.Popen] = []
        import os

        for i in range(n_replicas):
            port = port_base + i
            cmd = [sys.executable, "-m", SERVER_MODULE,
                   model_path, "--host", host, "--port", str(port),
                   "--batch", str(batch_per_group)]
            if native:
                cmd.append("--native")
            cmd += list(extra_args or [])
            env = dict(os.environ)
            if env_per_replica and i < len(env_per_replica):
                env.update(env_per_replica[i])
            self.procs.append(subprocess.Popen(
                cmd, stderr=subprocess.PIPE, env=env))
            self.addrs.append((host, port))

    def wait_ready(self, timeout: float = 300.0) -> None:
        """Block until every replica printed its listen line."""
        import selectors
        import threading

        deadline = time.time() + timeout
        for p in self.procs:
            # select before readline: a replica that hangs before printing
            # anything (a wedged device initialisation) must trip the
            # timeout, not block forever
            sel = selectors.DefaultSelector()
            sel.register(p.stderr, selectors.EVENT_READ)
            try:
                while True:
                    left = deadline - time.time()
                    if left <= 0:
                        raise TimeoutError("replica did not become ready")
                    if not sel.select(timeout=min(left, 1.0)):
                        continue
                    line = p.stderr.readline()
                    if not line:
                        raise RuntimeError(
                            f"replica exited with {p.poll()} before listening")
                    sys.stderr.buffer.write(line)
                    if b"listening" in line:
                        break
            finally:
                sel.close()
            # keep draining this replica's stderr (stats lines every ~10 s):
            # an unread PIPE fills its 64 KB buffer and then BLOCKS the
            # replica's next stderr write, freezing its serving loop
            threading.Thread(target=self._relay_stderr, args=(p,),
                             daemon=True).start()

    @staticmethod
    def _relay_stderr(p) -> None:
        for line in p.stderr:
            sys.stderr.buffer.write(line)
            sys.stderr.buffer.flush()

    def close(self) -> None:
        for p in self.procs:
            p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()

    def __enter__(self):
        self.wait_ready()
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class RoutedClient:
    """One logical streaming client over many replicas.

    Opens one connection per replica with a single demultiplexing reader
    task each (frames fan out into per-stream queues — concurrent streams on
    one replica share the connection). START goes to the least-loaded
    replica. Returned stream handles are opaque ints that encode the
    replica, so push/end/receive route transparently.
    """

    # handle = (replica_idx << 32) | replica-local sid. Stream ids are u32 on
    # the wire (server-protocol.h), so 32 bits holds every possible sid —
    # a narrower shift would alias long-lived replicas' high sids across
    # replicas. Handles are plain Python ints, never serialized.
    _REP_SHIFT = 32

    def __init__(self, clients: list[StreamClient]):
        self.clients = clients
        self.live: list[int] = [0] * len(clients)
        self._rr = 0
        self._queues: dict[int, asyncio.Queue] = {}  # handle -> frame queue
        self._started: list[asyncio.Queue] = [asyncio.Queue()
                                              for _ in clients]
        self._readers = [asyncio.ensure_future(self._demux(rep))
                         for rep in range(len(clients))]

    @classmethod
    async def connect(cls, addrs: list[tuple[str, int]]) -> "RoutedClient":
        clients = [await StreamClient.connect(h, p) for h, p in addrs]
        return cls(clients)

    async def _demux(self, rep: int) -> None:
        """Single reader per replica connection: fan frames out by stream.
        STARTED / start-time ERROR frames (no subscriber yet) land in the
        per-replica started queue for the start_stream waiter."""
        try:
            while True:
                opcode, sid, payload = await self.clients[rep].recv()
                handle = (rep << self._REP_SHIFT) | sid
                q = self._queues.get(handle)
                if q is not None:
                    q.put_nowait((opcode, payload))
                elif opcode in (P.OP_STARTED, P.OP_ERROR):
                    self._started[rep].put_nowait((opcode, payload))
                if opcode == P.OP_ENDED:
                    self.live[rep] = max(0, self.live[rep] - 1)
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            pass
        finally:
            # the replica connection is gone: wake every waiter parked on
            # one of its queues (transcribe()'s consume, start_stream's
            # started.get) instead of leaving them hanging forever
            for handle, q in list(self._queues.items()):
                if handle >> self._REP_SHIFT == rep:
                    q.put_nowait((None, b""))
            self._started[rep].put_nowait(
                (P.OP_ERROR, b"replica connection lost"))

    def _pick(self) -> int:
        lo = min(self.live)
        cands = [i for i, n in enumerate(self.live) if n == lo]
        rep = cands[self._rr % len(cands)]
        self._rr += 1
        return rep

    async def start_stream(self, right_context: int = 0,
                           lang: str | None = None) -> int:
        rep = self._pick()
        cfg: dict = {"right_context": right_context}
        if lang:
            cfg["lang"] = lang
        await self.clients[rep].send(P.OP_STREAM_START, 0, json.dumps(cfg))
        opcode, payload = await asyncio.wait_for(
            self._started[rep].get(), timeout=120)
        if opcode == P.OP_ERROR:
            raise RuntimeError(payload.decode())
        sid = int(json.loads(payload)["id"])
        self.live[rep] += 1
        handle = (rep << self._REP_SHIFT) | sid
        self._queues[handle] = asyncio.Queue()
        return handle

    def _route(self, handle: int) -> tuple[int, int]:
        return handle >> self._REP_SHIFT, handle & ((1 << self._REP_SHIFT) - 1)

    async def push(self, handle: int, audio_i16: np.ndarray) -> None:
        rep, sid = self._route(handle)
        await self.clients[rep].push(sid, audio_i16)

    async def end_stream(self, handle: int) -> None:
        rep, sid = self._route(handle)
        await self.clients[rep].send(P.OP_STREAM_END, sid)

    async def transcribe(self, handle: int, audio_i16: np.ndarray,
                         chunk_ms: int = 200) -> str:
        """Push a whole buffer on an open stream and collect text to ENDED."""
        q = self._queues[handle]
        texts: list[str] = []

        async def consume():
            while True:
                opcode, payload = await q.get()
                if opcode is None:  # demux sentinel: replica died
                    raise ConnectionError("replica connection lost")
                if opcode == P.OP_TEXT:
                    texts.append(payload.decode("utf-8", errors="replace"))
                elif opcode == P.OP_ENDED:
                    if payload:
                        texts.append(payload.decode("utf-8", errors="replace"))
                    return

        task = asyncio.create_task(consume())
        step = 16 * chunk_ms
        for off in range(0, len(audio_i16), step):
            await self.push(handle, audio_i16[off : off + step])
        await self.end_stream(handle)
        await task
        self._queues.pop(handle, None)
        return "".join(texts)

    def close(self) -> None:
        for t in self._readers:
            t.cancel()
        for c in self.clients:
            c.close()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="launch N server replicas (one per chip/host)")
    ap.add_argument("model")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port-base", type=int, default=8090)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--native", action="store_true")
    args = ap.parse_args(argv)

    rs = ReplicaSet(args.model, args.replicas, args.host, args.port_base,
                    args.batch, native=args.native)
    try:
        rs.wait_ready()
        print(json.dumps({"replicas": [f"{h}:{p}" for h, p in rs.addrs]}))
        while all(p.poll() is None for p in rs.procs):
            time.sleep(1.0)
        return 1  # a replica died
    except KeyboardInterrupt:
        return 0
    finally:
        rs.close()


if __name__ == "__main__":
    raise SystemExit(main())
