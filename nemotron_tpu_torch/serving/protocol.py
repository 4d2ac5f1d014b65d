"""Wire protocol: [u8 opcode][u32 stream_id][u32 payload_len][payload], LE.

Byte-compatible with the reference server (src/server-protocol.h:25-56) so the
reference's scripts/stream_client.py works unchanged against this server.
"""

from __future__ import annotations

import json
import struct

HEADER = struct.Struct("<BII")
HEADER_SIZE = HEADER.size  # 9

# Client -> Server
OP_STREAM_START = 0x01  # payload: JSON {"lang":..., "right_context":N} (optional)
OP_PUSH = 0x02          # payload: s16le PCM @16 kHz mono
OP_STREAM_END = 0x03
OP_SET_LANG = 0x04      # payload: UTF-8 language code

# Server -> Client
OP_STARTED = 0x81       # payload: JSON {"id":N}
OP_ACK = 0x82           # payload: JSON {"queued_samples":N}
OP_TEXT = 0x83          # payload: UTF-8 incremental transcript
OP_ENDED = 0x84         # payload: UTF-8 final flushed text
OP_LANG_SET = 0x85      # payload: JSON {"id":N,"lang":...,"index":M}
# Diarization frames (BEYOND the reference, which exposes diarization only
# via CLI; opt-in per stream with {"diarize": true} in OP_STREAM_START, so
# the wire stays byte-compatible for clients that never ask). Incremental
# frames are word JSONL ({"word":...,"at":...}); the final frame (sent
# before OP_ENDED) is {"type":"result","speaker_text":...,"rttm":...,
# "n_speakers":N}.
OP_DIARIZE = 0x86
OP_ERROR = 0x8F         # payload: UTF-8 message

# Fairness: PUSH payloads are split into <= 8000-sample (~0.5 s) segments so
# the engine interleaves sessions (reference: nemo-server.cpp:44).
MAX_SEGMENT_SAMPLES = 8000

# Global queued-PCM admission budget (reference: nemo-server.cpp:43).
DEFAULT_MEM_BUDGET = 64 * 1024 * 1024


def pack(opcode: int, stream_id: int, payload: bytes | str = b"") -> bytes:
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    return HEADER.pack(opcode, stream_id, len(payload)) + payload


def pack_json(opcode: int, stream_id: int, obj) -> bytes:
    return pack(opcode, stream_id, json.dumps(obj))
