"""ctypes bindings for the native host runtime (csrc/host/nemotron_host.cpp).

Builds the shared library on first use (g++ -O3) and caches it in the
package's git-ignored `_build/`. Every entry point has a NumPy fallback so
the framework works without a compiler; `HAVE_NATIVE` reports which path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "host", "nemotron_host.cpp")
_SO = os.path.join(_PKG, "_build", "libnemotron_host.so")

_lib = None
_lock = threading.Lock()


def _build() -> str | None:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", _SO, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        return _SO
    except Exception:
        return None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SRC):
            _lib = False
            return _lib
        so = _build()
        if so is None:
            _lib = False
            return _lib
        lib = ctypes.CDLL(so)
        lib.pcm_i16_to_f32_preemph.restype = ctypes.c_float
        lib.pcm_i16_to_f32_preemph.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p]
        lib.preemph_f32.restype = ctypes.c_float
        lib.preemph_f32.argtypes = lib.pcm_i16_to_f32_preemph.argtypes
        lib.frame_signal.restype = None
        lib.frame_signal.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        _lib = lib
        return _lib


def have_native() -> bool:
    return bool(_load())


def pcm_to_f32_preemph(audio, preemph: float, last_sample: float):
    """s16 (or f32) samples -> (pre-emphasized f32 array, new carry)."""
    audio = np.ascontiguousarray(audio)
    n = audio.size
    out = np.empty(n, np.float32)
    if n == 0:
        return out, last_sample
    lib = _load()
    if lib:
        if audio.dtype == np.int16:
            carry = lib.pcm_i16_to_f32_preemph(
                audio.ctypes.data, n, preemph, last_sample, out.ctypes.data)
        else:
            a32 = np.ascontiguousarray(audio, np.float32)
            carry = lib.preemph_f32(
                a32.ctypes.data, n, preemph, last_sample, out.ctypes.data)
        return out, float(carry)
    # numpy fallback
    x = (audio.astype(np.float32) / 32768.0 if audio.dtype == np.int16
         else audio.astype(np.float32))
    prev = np.empty_like(x)
    prev[0] = last_sample
    prev[1:] = x[:-1]
    np.subtract(x, preemph * prev, out=out)
    return out, float(x[-1])


def frame_signal(buf: np.ndarray, n_frames: int, hop: int, frame_len: int,
                 out: np.ndarray | None = None) -> np.ndarray:
    buf = np.ascontiguousarray(buf, np.float32)
    if out is None:
        out = np.empty((n_frames, frame_len), np.float32)
    lib = _load()
    if lib and out.flags.c_contiguous:
        lib.frame_signal(buf.ctypes.data, n_frames, hop, frame_len,
                         out.ctypes.data)
    else:
        for t in range(n_frames):
            out[t] = buf[t * hop : t * hop + frame_len]
    return out
