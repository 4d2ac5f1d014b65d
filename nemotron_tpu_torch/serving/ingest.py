"""ctypes bindings for the native ingest server (csrc/host/ingest_server.cpp).

The C++ layer owns the sockets, the wire protocol, PCM staging rings, ACKs
and the admission budget on a native thread that never touches the GIL; this
module is the thin typed interface the engine thread uses to pull staged
audio (one batched call per tick) and exchange control events. See the C++
header comment for the full rationale (the TPU client holds the GIL for the
whole device round-trip, which starves any Python-side socket loop).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "host", "ingest_server.cpp")
_SO = os.path.join(_PKG, "_build", "libnemotron_ingest.so")

_lib = None
_lock = threading.Lock()
# why the last _load failed (the compiler's message, or the loader's)
_load_error = ""

# control event types (ingest_server.cpp)
EV_START, EV_SET_LANG, EV_END, EV_DROP = 1, 2, 3, 4


def _load():
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SRC):
            _load_error = f"{_SRC} is missing"
            _lib = False
            return _lib
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                os.makedirs(os.path.dirname(_SO), exist_ok=True)
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-pthread",
                     "-o", _SO, _SRC],
                    check=True, capture_output=True, timeout=180)
            lib = ctypes.CDLL(_SO)
        except subprocess.CalledProcessError as e:
            _load_error = (f"g++ failed building {_SRC}:\n"
                           + e.stderr.decode("utf-8", "replace"))
            _lib = False
            return _lib
        except Exception as e:  # no g++, a timeout, a bad library
            _load_error = f"{type(e).__name__}: {e}"
            _lib = False
            return _lib
        c = ctypes
        lib.ingest_start.restype = c.c_int64
        lib.ingest_start.argtypes = [c.c_char_p, c.c_int32, c.c_char_p,
                                     c.c_int64]
        lib.ingest_stop.restype = None
        lib.ingest_stop.argtypes = []
        lib.ingest_wait.restype = c.c_int32
        lib.ingest_wait.argtypes = [c.c_int32]
        lib.ingest_poll_control.restype = c.c_int64
        lib.ingest_poll_control.argtypes = [
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64,
            c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p]
        lib.ingest_register_stream.restype = None
        lib.ingest_register_stream.argtypes = [c.c_uint64, c.c_uint32]
        lib.ingest_send.restype = None
        lib.ingest_send.argtypes = [c.c_uint64, c.c_uint8, c.c_uint32,
                                    c.c_void_p, c.c_int64]
        lib.ingest_status.restype = None
        lib.ingest_status.argtypes = [c.c_void_p, c.c_int64, c.c_void_p,
                                      c.c_void_p]
        lib.ingest_take_block.restype = c.c_int64
        lib.ingest_take_block.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                          c.c_int64, c.c_void_p]
        lib.ingest_drop_stream.restype = None
        lib.ingest_drop_stream.argtypes = [c.c_uint32]
        _lib = lib
        return _lib


def have_native_ingest() -> bool:
    return bool(_load())


def require_native_ingest() -> None:
    """Build and load the library, or raise RuntimeError with the reason
    (the compiler's message): a server asked for the native path never
    falls back to another."""
    if not _load():
        raise RuntimeError(f"native ingest library unavailable: {_load_error}")


class NativeIngest:
    """One running native ingest server (process-wide singleton in the C++
    layer). All methods are safe to call from the engine thread while the IO
    thread runs; ctypes releases the GIL around each call."""

    def __init__(self, host: str | None = None, port: int = 0,
                 unix_path: str | None = None,
                 budget_bytes: int = 64 << 20):
        lib = _load()
        if not lib:
            raise RuntimeError("native ingest library unavailable")
        self._lib = lib
        bound = lib.ingest_start(
            (host or "").encode(), port, (unix_path or "").encode(),
            budget_bytes)
        if bound < 0:
            raise RuntimeError(
                f"ingest_start failed (host={host} port={port} "
                f"unix={unix_path})")
        self.port = int(bound)
        self.unix_path = unix_path
        self._stopped = False
        # poll_control scratch, allocated once: it runs twice per iteration
        # of the serving loop, and a fresh 1 MB buffer per call is pure
        # allocator churn on the latency-critical engine thread. Only that
        # thread polls (engine owns all control flow), so reuse is safe.
        self._pc_max = 512
        self._pc_types = np.empty(self._pc_max, np.uint8)
        self._pc_conns = np.empty(self._pc_max, np.uint64)
        self._pc_sids = np.empty(self._pc_max, np.uint32)
        self._pc_cap = 1 << 20
        self._pc_buf = np.empty(self._pc_cap, np.uint8)
        self._pc_offs = np.empty(self._pc_max, np.int64)
        self._pc_lens = np.empty(self._pc_max, np.int64)

    def stop(self) -> None:
        if not self._stopped:
            self._stopped = True
            self._lib.ingest_stop()

    def wait(self, timeout_ms: int = 50) -> bool:
        """Sleep until ingest work arrives (or timeout). GIL-free."""
        return bool(self._lib.ingest_wait(timeout_ms))

    def poll_control(self):
        """Drain control events -> list of (type, conn, sid, payload bytes).
        Engine-thread only (reuses per-instance scratch buffers)."""
        types, conns, sids = self._pc_types, self._pc_conns, self._pc_sids
        buf, offs, lens = self._pc_buf, self._pc_offs, self._pc_lens
        n = self._lib.ingest_poll_control(
            types.ctypes.data, conns.ctypes.data, sids.ctypes.data,
            self._pc_max, buf.ctypes.data, self._pc_cap, offs.ctypes.data,
            lens.ctypes.data)
        out = []
        for i in range(n):
            pl = bytes(buf[offs[i] : offs[i] + lens[i]]) if lens[i] else b""
            out.append((int(types[i]), int(conns[i]), int(sids[i]), pl))
        return out

    def register_stream(self, conn: int, sid: int) -> None:
        self._lib.ingest_register_stream(conn, sid)

    def send(self, conn: int, opcode: int, sid: int,
             payload: bytes | str = b"") -> None:
        if isinstance(payload, str):
            payload = payload.encode("utf-8")
        self._lib.ingest_send(conn, opcode, sid, payload, len(payload))

    def status(self, sids: np.ndarray):
        """[N] uint32 stream ids -> (staged int64 [N] (-1 if gone),
        total_pushed uint64 [N])."""
        sids = np.ascontiguousarray(sids, np.uint32)
        staged = np.empty(len(sids), np.int64)
        pushed = np.empty(len(sids), np.uint64)
        self._lib.ingest_status(sids.ctypes.data, len(sids),
                                staged.ctypes.data, pushed.ctypes.data)
        return staged, pushed

    def take_block(self, sids: np.ndarray, take_n: np.ndarray,
                   out: np.ndarray) -> int:
        """Fill out[i, :take_n[i]] from stream sids[i]'s ring (zero-padded
        shortfall) for every take_n[i] > 0. One native call for the whole
        tick block; releases admission budget as it consumes."""
        assert out.dtype == np.int16 and out.flags.c_contiguous
        sids = np.ascontiguousarray(sids, np.uint32)
        take_n = np.ascontiguousarray(take_n, np.int32)
        return int(self._lib.ingest_take_block(
            sids.ctypes.data, take_n.ctypes.data, len(sids),
            out.shape[1], out.ctypes.data))

    def drop_stream(self, sid: int) -> None:
        self._lib.ingest_drop_stream(sid)
