"""GGUF v3 writer + quantizers.

Produces files byte-compatible with what the reference loader expects
(reference format spec: scripts/convert_to_gguf.py:486-540, docs/TENSOR_FORMAT.md).
Used by our .nemo converter (scripts/convert_nemo_to_gguf.py) and by tests to
round-trip synthetic models through the reader.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO

import numpy as np

from .reader import (
    DEFAULT_ALIGNMENT,
    GGML_F16,
    GGML_F32,
    GGML_Q4_0,
    GGML_Q8_0,
    QK,
    T_ARRAY,
    T_FLOAT32,
    T_INT32,
    T_STRING,
    T_UINT32,
    tensor_nbytes,
)


def quantize_q8_0(data: np.ndarray) -> bytes:
    flat = np.ascontiguousarray(data, dtype=np.float32).reshape(-1)
    pad = (-len(flat)) % QK
    if pad:
        flat = np.pad(flat, (0, pad))
    blocks = flat.reshape(-1, QK)
    amax = np.max(np.abs(blocks), axis=1)
    scales = np.where(amax != 0, amax / 127.0, 0.0).astype(np.float16)
    s32 = scales.astype(np.float32)[:, None]
    q = np.where(s32 != 0, np.round(blocks / np.where(s32 != 0, s32, 1.0)), 0.0)
    q = q.astype(np.int8)
    out = np.empty(len(blocks), dtype=np.dtype([("scale", np.float16), ("q", np.int8, QK)]))
    out["scale"] = scales
    out["q"] = q
    return out.tobytes()


def quantize_q4_0(data: np.ndarray) -> bytes:
    flat = np.ascontiguousarray(data, dtype=np.float32).reshape(-1)
    pad = (-len(flat)) % QK
    if pad:
        flat = np.pad(flat, (0, pad))
    blocks = flat.reshape(-1, QK)
    amax = np.max(np.abs(blocks), axis=1)
    scales = np.where(amax != 0, amax / 7.0, 0.0).astype(np.float16)
    s32 = scales.astype(np.float32)[:, None]
    q = np.where(s32 != 0, np.round(blocks / np.where(s32 != 0, s32, 1.0)), 0.0)
    q = np.clip(q, -8, 7).astype(np.int8)
    qu = (q + 8).astype(np.uint8)
    packed = (qu[:, : QK // 2] & 0x0F) | ((qu[:, QK // 2 :] & 0x0F) << 4)
    out = np.empty(
        len(blocks), dtype=np.dtype([("scale", np.float16), ("q", np.uint8, QK // 2)])
    )
    out["scale"] = scales
    out["q"] = packed.astype(np.uint8)
    return out.tobytes()


def encode_tensor(data: np.ndarray, ggml_type: int) -> bytes:
    if ggml_type == GGML_F32:
        return np.ascontiguousarray(data, dtype=np.float32).tobytes()
    if ggml_type == GGML_F16:
        return np.ascontiguousarray(data, dtype=np.float16).tobytes()
    if ggml_type == GGML_Q8_0:
        return quantize_q8_0(data)
    if ggml_type == GGML_Q4_0:
        return quantize_q4_0(data)
    raise ValueError(f"unsupported ggml type {ggml_type}")


def _w_string(f: BinaryIO, s: str | bytes) -> None:
    b = s.encode("utf-8") if isinstance(s, str) else s
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _w_kv(f: BinaryIO, key: str, value: Any) -> None:
    _w_string(f, key)
    if isinstance(value, bool):
        raise ValueError("bool KVs not used by this format")
    if isinstance(value, int):
        if value < 0:
            f.write(struct.pack("<i", T_INT32))
            f.write(struct.pack("<i", value))
        else:
            f.write(struct.pack("<i", T_UINT32))
            f.write(struct.pack("<I", value))
    elif isinstance(value, float):
        f.write(struct.pack("<i", T_FLOAT32))
        f.write(struct.pack("<f", value))
    elif isinstance(value, (str, bytes)):
        f.write(struct.pack("<i", T_STRING))
        _w_string(f, value)
    elif isinstance(value, (list, tuple)):
        f.write(struct.pack("<i", T_ARRAY))
        if all(isinstance(v, str) for v in value):
            f.write(struct.pack("<i", T_STRING))
            f.write(struct.pack("<Q", len(value)))
            for v in value:
                _w_string(f, v)
        elif all(isinstance(v, int) for v in value):
            f.write(struct.pack("<i", T_INT32))
            f.write(struct.pack("<Q", len(value)))
            for v in value:
                f.write(struct.pack("<i", v))
        else:
            raise ValueError("mixed-type arrays unsupported")
    else:
        raise ValueError(f"unsupported KV value type for {key}: {type(value)}")


def write_gguf(
    path: str,
    kv: dict[str, Any],
    tensors: dict[str, np.ndarray],
    tensor_types: dict[str, int] | None = None,
) -> None:
    """Write a GGUF v3 file.

    `tensors` values are numpy arrays in numpy/PyTorch dim order (reversed to
    GGUF `ne` order on disk). `tensor_types` optionally maps name -> ggml type;
    default is F32.
    """
    tensor_types = tensor_types or {}
    infos = []
    offset = 0
    for name, data in tensors.items():
        ttype = tensor_types.get(name, GGML_F32)
        payload = encode_tensor(data, ttype)
        offset = (offset + DEFAULT_ALIGNMENT - 1) // DEFAULT_ALIGNMENT * DEFAULT_ALIGNMENT
        ne = list(reversed(data.shape)) or [1]
        infos.append((name, ne, ttype, offset, payload))
        offset += len(payload)

    with open(path, "wb") as f:
        f.write(b"GGUF")
        f.write(struct.pack("<I", 3))
        f.write(struct.pack("<q", len(infos)))
        f.write(struct.pack("<q", len(kv)))
        for key, value in kv.items():
            _w_kv(f, key, value)
        for name, ne, ttype, off, _payload in infos:
            _w_string(f, name)
            f.write(struct.pack("<I", len(ne)))
            for d in ne:
                f.write(struct.pack("<q", d))
            f.write(struct.pack("<iQ", ttype, off))
        pos = f.tell()
        pad = (pos + DEFAULT_ALIGNMENT - 1) // DEFAULT_ALIGNMENT * DEFAULT_ALIGNMENT - pos
        f.write(b"\x00" * pad)
        data_start = f.tell()
        for name, _ne, ttype, off, payload in infos:
            cur = f.tell()
            target = data_start + off
            if target > cur:
                f.write(b"\x00" * (target - cur))
            f.write(payload)
