"""Tensor tracing: shape-checked binary dump appenders.

Same on-disk format as the reference's append_dump_array
(src/nemo-stream.cpp:938-1010): a 32-byte header of four little-endian i64
dims, then raw f32 payloads appended once per step. Interoperates with the
reference's NeMo-side hook dumps and scripts/compare_tensors.py, so the
dump-and-diff parity workflow (docs/STREAMING-v2.md:117-149) carries over.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_seen: dict[str, tuple[int, int, int, int]] = {}


def reset() -> None:
    _seen.clear()


def append_dump_array(data, filename: str) -> None:
    arr = np.ascontiguousarray(np.asarray(data), dtype=np.float32)
    ne = list(reversed(arr.shape)) + [1] * (4 - arr.ndim)  # ggml ne order
    ne = tuple(int(x) for x in ne[:4])
    if filename not in _seen:
        with open(filename, "wb") as f:
            f.write(struct.pack("<4q", *ne))
        _seen[filename] = ne
    elif _seen[filename] != ne:
        raise ValueError(
            f"{filename}: shape changed across appends "
            f"({_seen[filename]} vs {ne})"
        )
    with open(filename, "ab") as f:
        f.write(arr.tobytes())


def read_dump(filename: str) -> np.ndarray:
    """Returns [n_steps, *shape] (numpy dim order)."""
    raw = Path(filename).read_bytes()
    ne = struct.unpack("<4q", raw[:32])
    shape = tuple(int(d) for d in reversed(ne) if d > 1) or (1,)
    data = np.frombuffer(raw[32:], dtype="<f4")
    n = int(np.prod(shape))
    steps = len(data) // n
    return data[: steps * n].reshape((steps,) + shape)
