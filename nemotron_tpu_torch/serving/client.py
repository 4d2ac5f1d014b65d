"""Async client for the streaming server (library + CLI).

Speaks the 9-byte-header protocol; usable for tests, benchmarking, and as a
replacement for the reference's scripts/stream_client.py.
"""

from __future__ import annotations

import asyncio
import json
import time

import numpy as np

from . import protocol as P


class StreamClient:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    @classmethod
    async def connect(cls, host: str | None = None, port: int | None = None,
                      unix_path: str | None = None) -> "StreamClient":
        if unix_path:
            r, w = await asyncio.open_unix_connection(unix_path)
        else:
            r, w = await asyncio.open_connection(host or "127.0.0.1", port or 8090)
        return cls(r, w)

    async def send(self, opcode: int, stream_id: int = 0,
                   payload: bytes | str = b"") -> None:
        self.writer.write(P.pack(opcode, stream_id, payload))
        await self.writer.drain()

    async def recv(self) -> tuple[int, int, bytes]:
        hdr = await self.reader.readexactly(P.HEADER_SIZE)
        opcode, stream_id, length = P.HEADER.unpack(hdr)
        payload = await self.reader.readexactly(length) if length else b""
        return opcode, stream_id, payload

    async def start_stream(self, right_context: int = 0,
                           lang: str | None = None,
                           diarize: bool = False,
                           num_speakers: int = -1) -> int:
        cfg: dict = {"right_context": right_context}
        if lang:
            cfg["lang"] = lang
        if diarize:
            cfg["diarize"] = True
            if num_speakers > 0:
                cfg["num_speakers"] = num_speakers
        await self.send(P.OP_STREAM_START, 0, json.dumps(cfg))
        opcode, _sid, payload = await self.recv()
        if opcode == P.OP_ERROR:
            raise RuntimeError(payload.decode())
        assert opcode == P.OP_STARTED, hex(opcode)
        return int(json.loads(payload)["id"])

    async def push(self, stream_id: int, audio_i16: np.ndarray) -> None:
        await self.send(P.OP_PUSH, stream_id,
                        np.asarray(audio_i16, dtype="<i2").tobytes())

    def close(self) -> None:
        self.writer.close()


async def transcribe_file(audio_i16: np.ndarray, host=None, port=None,
                          unix_path=None, right_context=0, lang=None,
                          chunk_ms=200, realtime=False,
                          on_text=None, diarize=False, num_speakers=-1,
                          on_diarize=None) -> str:
    """Stream a whole buffer; returns the full transcript. With diarize=True
    (server started with --diarize) every OP_DIARIZE JSONL line is passed to
    on_diarize; the final {"type":"result",...} line arrives before ENDED."""
    client = await StreamClient.connect(host, port, unix_path)
    sid = await client.start_stream(right_context, lang, diarize=diarize,
                                    num_speakers=num_speakers)
    chunk = 16 * chunk_ms

    texts: list[str] = []
    done = asyncio.Event()
    reader_err: list[BaseException] = []

    async def reader():
        # Failures must WAKE the waiter, not die silently in the task:
        # a server crash (IncompleteReadError) or an OP_ERROR frame would
        # otherwise leave `await done.wait()` hanging forever.
        try:
            while True:
                opcode, rsid, payload = await client.recv()
                if rsid != sid:
                    continue
                if opcode == P.OP_TEXT:
                    t = payload.decode("utf-8", errors="replace")
                    texts.append(t)
                    if on_text:
                        on_text(t)
                elif opcode == P.OP_DIARIZE:
                    if on_diarize:
                        on_diarize(payload.decode("utf-8", errors="replace"))
                elif opcode == P.OP_ENDED:
                    t = payload.decode("utf-8", errors="replace")
                    if t:
                        texts.append(t)
                        if on_text:
                            on_text(t)
                    return
                elif opcode == P.OP_ERROR:
                    raise RuntimeError(payload.decode())
        except BaseException as e:
            reader_err.append(e)
        finally:
            done.set()

    rtask = asyncio.create_task(reader())
    t0 = time.time()
    for off in range(0, len(audio_i16), chunk):
        await client.push(sid, audio_i16[off : off + chunk])
        if realtime:
            target = (off + chunk) / 16000.0
            dt = target - (time.time() - t0)
            if dt > 0:
                await asyncio.sleep(dt)
    await client.send(P.OP_STREAM_END, sid)
    await done.wait()
    rtask.cancel()
    client.close()
    if reader_err:
        raise reader_err[0]
    return "".join(texts)


def main(argv=None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("audio", help="s16le 16 kHz mono PCM file")
    ap.add_argument("--tcp", default="127.0.0.1:8090")
    ap.add_argument("--unix", default=None)
    ap.add_argument("--lang", default=None)
    ap.add_argument("--right-context", type=int, default=0)
    ap.add_argument("--chunk-ms", type=int, default=200)
    ap.add_argument("--realtime", action="store_true")
    ap.add_argument("--diarize", action="store_true",
                    help="request per-stream diarization (server must run "
                         "with --diarize); prints JSONL frames to stderr")
    ap.add_argument("--num-speakers", type=int, default=-1)
    args = ap.parse_args(argv)

    audio = np.fromfile(args.audio, dtype="<i2")
    host, port = None, None
    if not args.unix:
        host, _, p = args.tcp.partition(":")
        port = int(p or 8090)

    def on_text(t):
        sys.stdout.write(t)
        sys.stdout.flush()

    def on_diarize(line):
        print(line, file=sys.stderr)

    text = asyncio.run(
        transcribe_file(audio, host, port, args.unix, args.right_context,
                        args.lang, args.chunk_ms, args.realtime, on_text,
                        diarize=args.diarize, num_speakers=args.num_speakers,
                        on_diarize=on_diarize)
    )
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
