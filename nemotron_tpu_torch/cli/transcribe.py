"""Offline transcription CLI on the PyTorch port, with the argv contract of
nemotron_tpu/cli/transcribe.py:

    python -m nemotron_tpu_torch.cli.transcribe <model.gguf>
        <audio.pcm|audio.wav|-> [more ...] [--timestamps] [--cpu | --cuda]

Each file is s16le 16 kHz mono PCM, a 16-bit .wav, or stdin (`-`, read
once; a second `-` reuses it). One file prints its text; several print
`name<TAB>text` lines and run as one ragged batch per segment
(`ASRModel.transcribe_audios`). The RTF line goes to stderr. The device is
the card (--cuda, the default) or the CPU (--cpu); nothing falls back
from one to the other. bf16 and Q8_0 / Q4_0 weights are reached through
the API (`ASRModel.from_gguf(dtype=..., keep_quantized=True)`), as in the
JAX package, whose offline CLI has no such options.
"""

from __future__ import annotations

import sys
import time

import numpy as np

USAGE = ("usage: transcribe <model.gguf> <audio.pcm|-> [more.pcm ...] "
         "[--timestamps] [--cpu|--cuda]")


def parse_args(argv: list[str]) -> dict:
    opts = {"timestamps": False, "device": "cuda", "files": []}
    for a in argv:
        if a == "--timestamps":
            opts["timestamps"] = True
        elif a in ("--cpu", "--cuda"):
            opts["device"] = a[2:]
        elif a.startswith("--"):
            raise SystemExit(f"transcribe: unknown option {a}\n{USAGE}")
        else:
            opts["files"].append(a)
    if len(opts["files"]) < 2:
        raise SystemExit(USAGE)
    return opts


def read_audios(paths: list[str]) -> list[np.ndarray]:
    from ..audio.wavio import maybe_read_audio

    audios, stdin_audio = [], None
    for path in paths:
        if path == "-":
            if stdin_audio is None:
                stdin_audio = np.frombuffer(sys.stdin.buffer.read(),
                                            dtype="<i2")
            audios.append(stdin_audio)
        else:
            audios.append(maybe_read_audio(path))
    return audios


def main(argv=None) -> int:
    opts = parse_args(argv if argv is not None else sys.argv[1:])

    import torch

    from ..api import ASRModel

    if opts["device"] == "cuda" and not torch.cuda.is_available():
        raise SystemExit("transcribe: --cuda (the default) needs a CUDA "
                         "card; pass --cpu to run on the CPU")
    model_path, names = opts["files"][0], opts["files"][1:]
    model = ASRModel.from_gguf(model_path, device=opts["device"])
    audios = read_audios(names)

    t0 = time.time()
    if len(audios) == 1:
        texts = [model.transcribe_audio(audios[0],
                                        timestamp_words=opts["timestamps"])]
    else:
        texts = model.transcribe_audios(audios,
                                        timestamp_words=opts["timestamps"])
    dt = time.time() - t0
    for name, text in zip(names, texts):
        print(f"{name}\t{text}" if len(texts) > 1 else text)
    secs = sum(len(a) for a in audios) / 16000.0
    rtf = dt / secs if secs > 0 else float("inf")
    print(f"audio: {secs:.2f}s  compute: {dt:.2f}s  RTF: {rtf:.4f}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
