"""Streaming transcription CLI on the PyTorch port, with the argv contract of
nemotron_tpu/cli/transcribe_stream.py:

    python -m nemotron_tpu_torch.cli.transcribe_stream <model.gguf>
        <audio.pcm|audio.wav|-> [chunk_ms=80] [right_context=0]
        [--lang CODE] [--timestamps] [--confidence] [--bf16] [--quantized]
        [--cpu | --cuda]

Reads s16le 16 kHz mono PCM (or a 16-bit .wav) from a file or stdin, prints
the text incrementally as it decodes, then an RTF summary on stderr. The
device is the card (--cuda, the default) or the CPU (--cpu); nothing falls
back from one to the other. NEMOTRON_TPU_PALLAS_ATTN_BLOCK=1, read once at
start-up, runs each layer's attention sub-block through kernel B3, as the
same variable selects the fused block in the JAX package.

right_context is 0, 1, 6 or 13 (the 80 ms, 160 ms, 560 ms and 1.12 s
latency modes). Refused until the port runs them (ROADMAP.md): the
diarization options --diarize, --rttm, --speaker-text, --json,
--num-speakers and --sub-shift.
"""

from __future__ import annotations

import io
import os
import sys
import time

import numpy as np

USAGE = ("usage: transcribe_stream <model.gguf> <audio.pcm|audio.wav|-> "
         "[chunk_ms] [right_context] [--lang CODE] [--timestamps] "
         "[--confidence] [--bf16] [--quantized] [--cpu|--cuda]")

_DIARIZE = ("--diarize", "--rttm", "--speaker-text", "--json",
            "--num-speakers", "--sub-shift")
_FLAGS = {"--timestamps": "timestamps", "--confidence": "confidence",
          "--bf16": "bf16", "--quantized": "quantized"}


def _refuse(msg: str):
    raise SystemExit(f"transcribe_stream: {msg}")


def parse_args(argv: list[str]) -> dict:
    opts = {"model": None, "audio": None, "chunk_ms": 80, "right_context": 0,
            "lang": None, "device": "cuda", **{v: False for v in _FLAGS.values()}}
    pos = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--lang":
            i += 1
            if i == len(argv):
                _refuse("--lang needs a language code")
            opts["lang"] = argv[i]
        elif a in _FLAGS:
            opts[_FLAGS[a]] = True
        elif a in ("--cpu", "--cuda"):
            opts["device"] = a[2:]
        elif a in _DIARIZE:
            _refuse(f"{a}: diarization is not supported by the torch port "
                    "yet (ROADMAP A13)")
        elif a.startswith("--"):
            _refuse(f"unknown option {a}\n{USAGE}")
        else:
            pos.append(a)
        i += 1
    if len(pos) < 2:
        raise SystemExit(USAGE)
    opts["model"], opts["audio"] = pos[0], pos[1]
    if len(pos) > 2:
        opts["chunk_ms"] = int(pos[2])
    if len(pos) > 3:
        opts["right_context"] = int(pos[3])
    if opts["chunk_ms"] <= 0:
        _refuse(f"chunk_ms must be positive, got {opts['chunk_ms']}")
    return opts


def _open_audio(path: str, sample_rate: int):
    if path == "-":
        return sys.stdin.buffer
    if path.endswith(".wav"):
        from ..audio.wavio import read_wav

        samples, rate = read_wav(path)
        if rate != sample_rate:
            raise SystemExit(f"expected {sample_rate} Hz wav, got {rate}")
        return io.BytesIO(samples.astype("<i2").tobytes())
    return open(path, "rb")


def main(argv=None) -> int:
    opts = parse_args(argv if argv is not None else sys.argv[1:])
    attn_block = os.environ.get("NEMOTRON_TPU_PALLAS_ATTN_BLOCK", "0") == "1"

    import torch

    from ..api import ASRModel
    from ..config import CacheConfig
    from ..streaming.session import StreamSession

    if opts["device"] == "cuda" and not torch.cuda.is_available():
        raise SystemExit("transcribe_stream: --cuda (the default) needs a "
                         "CUDA card; pass --cpu to run on the CPU")
    t0 = time.time()
    model = ASRModel.from_gguf(
        opts["model"], dtype=torch.bfloat16 if opts["bf16"] else torch.float32,
        device=opts["device"], keep_quantized=opts["quantized"],
        attn_block=attn_block, confidence=opts["confidence"])
    print(f"loaded model in {time.time() - t0:.1f}s "
          f"(d_model={model.hp.d_model}, layers={model.hp.n_layers}, "
          f"{model.backend_name}{', attention block B3' if attn_block else ''})",
          file=sys.stderr)

    cfg = CacheConfig.for_mode(opts["right_context"], model.hp)
    sess = StreamSession(model, cfg, lang=opts["lang"],
                         timestamp_words=opts["timestamps"])
    chunk_samples = opts["chunk_ms"] * cfg.sample_rate // 1000
    f = _open_audio(opts["audio"], cfg.sample_rate)
    print(f"streaming: chunk={opts['chunk_ms']}ms right_context="
          f"{opts['right_context']} latency={cfg.latency_ms}ms",
          file=sys.stderr)

    total_samples = 0
    t_start = time.time()
    try:
        while True:
            raw = f.read(chunk_samples * 2)
            if not raw:
                break
            audio = np.frombuffer(raw, dtype="<i2")
            total_samples += len(audio)
            text = sess.process_incremental(audio)
            if text:
                sys.stdout.write(text)
                sys.stdout.flush()
    finally:
        if f is not sys.stdin.buffer:
            f.close()

    sys.stdout.write(sess.finalize() + "\n")
    sys.stdout.flush()

    elapsed = time.time() - t_start
    audio_secs = total_samples / cfg.sample_rate
    rtf = elapsed / audio_secs if audio_secs else 0.0
    print(f"\naudio: {audio_secs:.2f}s  compute: {elapsed:.2f}s  "
          f"RTF: {rtf:.4f} ({1.0 / rtf if rtf else 0:.1f}x real-time)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
