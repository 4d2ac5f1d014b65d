"""SentencePiece-style detokenizer with optional word timestamps.

Reference: tokens_to_text (src/nemo-ggml.cpp:1556-1583) and timed_token
(src/nemo-ggml.h:383-395). The SentencePiece word-start marker U+2581 maps to a
space; inline <xx-XX> language markers (multilingual model) pass through.
Timestamps are encoder-frame indices x 1280 samples / 16 kHz = 80 ms units.
"""

from __future__ import annotations

import dataclasses

WORD_START = "▁"  # ▁
FRAME_SAMPLES = 1280
SAMPLE_RATE = 16000


@dataclasses.dataclass(frozen=True)
class TimedToken:
    token_id: int
    frame_idx: int

    def to_seconds(
        self, frame_samples: int = FRAME_SAMPLES, sample_rate: int = SAMPLE_RATE
    ) -> float:
        return self.frame_idx * frame_samples / sample_rate


class Tokenizer:
    def __init__(self, vocab: list[str]):
        self.vocab = list(vocab)

    def __len__(self) -> int:
        return len(self.vocab)

    def piece(self, token_id: int) -> str:
        if 0 <= token_id < len(self.vocab):
            return self.vocab[token_id]
        return ""

    def decode(self, token_ids, timestamp_words: bool = False, frames=None) -> str:
        """token_ids: iterable of ids; frames: optional parallel frame indices
        used when timestamp_words is set (emits {%.2f} after each word start)."""
        out = []
        for i, tid in enumerate(token_ids):
            piece = self.piece(int(tid))
            if piece.startswith(WORD_START):
                out.append(" ")
                if timestamp_words and frames is not None:
                    secs = TimedToken(int(tid), int(frames[i])).to_seconds()
                    out.append(f"{{{secs:.2f}}}")
                out.append(piece[len(WORD_START):])
            else:
                out.append(piece)
        return "".join(out)
