"""Pure-Python GGUF reader (no external deps beyond numpy).

Parses the GGUF v2/v3 container produced by the reference converter
(reference: scripts/convert_to_gguf.py:29-57 for constants, :486-540 for layout)
and dequantizes Q8_0/Q4_0/F16 payloads to float32 numpy arrays.

Returned tensor arrays use *numpy/PyTorch* dimension order, i.e. the reverse of
the on-disk GGUF `ne` order (GGUF stores dims innermost-first).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, BinaryIO

import numpy as np

GGUF_MAGIC = b"GGUF"
DEFAULT_ALIGNMENT = 32

# GGUF metadata value types
T_UINT8, T_INT8, T_UINT16, T_INT16 = 0, 1, 2, 3
T_UINT32, T_INT32, T_FLOAT32, T_BOOL = 4, 5, 6, 7
T_STRING, T_ARRAY, T_UINT64, T_INT64, T_FLOAT64 = 8, 9, 10, 11, 12

_SCALAR_FMT = {
    T_UINT8: "<B", T_INT8: "<b", T_UINT16: "<H", T_INT16: "<h",
    T_UINT32: "<I", T_INT32: "<i", T_FLOAT32: "<f", T_BOOL: "<?",
    T_UINT64: "<Q", T_INT64: "<q", T_FLOAT64: "<d",
}

# ggml tensor dtypes
GGML_F32, GGML_F16, GGML_Q4_0, GGML_Q8_0 = 0, 1, 2, 8
QK = 32  # quantization block size (elements)

_TYPE_NAME = {GGML_F32: "F32", GGML_F16: "F16", GGML_Q4_0: "Q4_0", GGML_Q8_0: "Q8_0"}


@dataclasses.dataclass
class TensorInfo:
    name: str
    shape: tuple[int, ...]  # numpy order (reversed from on-disk ne)
    ggml_type: int
    offset: int             # relative to data section start

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return tensor_nbytes(self.n_elements, self.ggml_type)

    @property
    def type_name(self) -> str:
        return _TYPE_NAME.get(self.ggml_type, str(self.ggml_type))


def tensor_nbytes(n_elements: int, ggml_type: int) -> int:
    if ggml_type == GGML_F32:
        return n_elements * 4
    if ggml_type == GGML_F16:
        return n_elements * 2
    if ggml_type == GGML_Q8_0:
        return (n_elements + QK - 1) // QK * (2 + QK)
    if ggml_type == GGML_Q4_0:
        return (n_elements + QK - 1) // QK * (2 + QK // 2)
    raise ValueError(f"unsupported ggml tensor type {ggml_type}")


def _read_string(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype in _SCALAR_FMT:
        fmt = _SCALAR_FMT[vtype]
        return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]
    if vtype == T_STRING:
        return _read_string(f)
    if vtype == T_ARRAY:
        (elem_type,) = struct.unpack("<i", f.read(4))
        (n,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, elem_type) for _ in range(n)]
    raise ValueError(f"unsupported GGUF KV type {vtype}")


def dequantize_q8_0(raw: bytes, n_elements: int) -> np.ndarray:
    """Q8_0: per-32-element blocks of [f16 scale][32 x i8]."""
    n_blocks = (n_elements + QK - 1) // QK
    block = np.dtype([("scale", np.float16), ("q", np.int8, QK)])
    arr = np.frombuffer(raw, dtype=block, count=n_blocks)
    out = arr["q"].astype(np.float32) * arr["scale"].astype(np.float32)[:, None]
    return out.reshape(-1)[:n_elements]


def dequantize_q4_0(raw: bytes, n_elements: int) -> np.ndarray:
    """Q4_0: per-32-element blocks of [f16 scale][16 packed bytes], values-8."""
    n_blocks = (n_elements + QK - 1) // QK
    block = np.dtype([("scale", np.float16), ("q", np.uint8, QK // 2)])
    arr = np.frombuffer(raw, dtype=block, count=n_blocks)
    lo = (arr["q"] & 0x0F).astype(np.int8) - 8
    hi = (arr["q"] >> 4).astype(np.int8) - 8
    vals = np.concatenate([lo, hi], axis=1).astype(np.float32)
    out = vals * arr["scale"].astype(np.float32)[:, None]
    return out.reshape(-1)[:n_elements]


def decode_tensor(raw: bytes, info: TensorInfo) -> np.ndarray:
    if info.ggml_type == GGML_F32:
        flat = np.frombuffer(raw, dtype=np.float32, count=info.n_elements)
    elif info.ggml_type == GGML_F16:
        flat = np.frombuffer(raw, dtype=np.float16, count=info.n_elements).astype(
            np.float32
        )
    elif info.ggml_type == GGML_Q8_0:
        flat = dequantize_q8_0(raw, info.n_elements)
    elif info.ggml_type == GGML_Q4_0:
        flat = dequantize_q4_0(raw, info.n_elements)
    else:
        raise ValueError(f"unsupported tensor type {info.ggml_type} for {info.name}")
    return flat.reshape(info.shape)


@dataclasses.dataclass
class GGUFFile:
    kv: dict[str, Any]
    tensors: dict[str, TensorInfo]
    data_offset: int
    path: str

    def load_tensor(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        with open(self.path, "rb") as f:
            f.seek(self.data_offset + info.offset)
            raw = f.read(info.nbytes)
        return decode_tensor(raw, info)

    def load_all(self) -> dict[str, np.ndarray]:
        out = {}
        with open(self.path, "rb") as f:
            for name, info in self.tensors.items():
                f.seek(self.data_offset + info.offset)
                out[name] = decode_tensor(f.read(info.nbytes), info)
        return out

    def raw_tensor(self, name: str) -> bytes:
        """Raw (still-quantized) payload for native int8 consumption."""
        info = self.tensors[name]
        with open(self.path, "rb") as f:
            f.seek(self.data_offset + info.offset)
            return f.read(info.nbytes)


def read_gguf(path: str) -> GGUFFile:
    with open(path, "rb") as f:
        if f.read(4) != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        (version,) = struct.unpack("<I", f.read(4))
        if version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {version}")
        n_tensors, n_kv = struct.unpack("<qq", f.read(16))

        kv: dict[str, Any] = {}
        for _ in range(n_kv):
            key = _read_string(f)
            (vtype,) = struct.unpack("<i", f.read(4))
            kv[key] = _read_value(f, vtype)

        tensors: dict[str, TensorInfo] = {}
        for _ in range(n_tensors):
            name = _read_string(f)
            (n_dims,) = struct.unpack("<I", f.read(4))
            ne = struct.unpack(f"<{n_dims}q", f.read(8 * n_dims))
            ggml_type, offset = struct.unpack("<iQ", f.read(12))
            tensors[name] = TensorInfo(
                name=name,
                shape=tuple(reversed(ne)),
                ggml_type=ggml_type,
                offset=offset,
            )

        align = int(kv.get("general.alignment", DEFAULT_ALIGNMENT))
        pos = f.tell()
        data_offset = (pos + align - 1) // align * align

    return GGUFFile(kv=kv, tensors=tensors, data_offset=data_offset, path=path)
