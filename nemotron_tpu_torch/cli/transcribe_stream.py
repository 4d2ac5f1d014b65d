"""Streaming transcription CLI on the PyTorch port, with the argv contract of
nemotron_tpu/cli/transcribe_stream.py:

    python -m nemotron_tpu_torch.cli.transcribe_stream <model.gguf>
        <audio.pcm|audio.wav|-> [chunk_ms=80] [right_context=0]
        [--lang CODE] [--timestamps] [--confidence] [--bf16] [--quantized]
        [--diarize <diarize.gguf>] [--rttm] [--speaker-text] [--json]
        [--num-speakers N] [--sub-shift MS] [--cpu | --cuda]

Reads s16le 16 kHz mono PCM (or a 16-bit .wav) from a file or stdin, prints
the text incrementally as it decodes, then an RTF summary on stderr. The
device is the card (--cuda, the default) or the CPU (--cpu); nothing falls
back from one to the other. --metal and --tpu are accepted for the JAX
CLI's argv and change nothing. NEMOTRON_TPU_PALLAS_ATTN_BLOCK=1, read once
at start-up, runs each layer's attention sub-block through kernel B3, as
the same variable selects the fused block in the JAX package.

right_context is 0, 1, 6 or 13 (the 80 ms, 160 ms, 560 ms and 1.12 s
latency modes). --diarize runs the diarization pipeline (MarbleNet VAD,
TitaNet-L embeddings, NME-SC) beside the transcription on the same device:
--json prints each word as a JSON line as it completes (with "conf" under
--confidence), and at the end the speaker-tagged text (--speaker-text, or
when --rttm is absent) and / or the RTTM (--rttm), as the JAX CLI does.
"""

from __future__ import annotations

import io
import os
import sys
import time

import numpy as np

USAGE = ("usage: transcribe_stream <model.gguf> <audio.pcm|audio.wav|-> "
         "[chunk_ms] [right_context] [--lang CODE] [--timestamps] "
         "[--confidence] [--bf16] [--quantized] [--diarize GGUF] [--rttm] "
         "[--speaker-text] [--json] [--num-speakers N] [--sub-shift MS] "
         "[--cpu|--cuda]")

_FLAGS = {"--timestamps": "timestamps", "--confidence": "confidence",
          "--bf16": "bf16", "--quantized": "quantized", "--rttm": "rttm",
          "--speaker-text": "speaker_text", "--json": "json"}
# options with a value: (key, conversion)
_VALUES = {"--lang": ("lang", str), "--diarize": ("diarize", str),
           "--num-speakers": ("num_speakers", int),
           "--sub-shift": ("sub_shift_ms", int)}


def _refuse(msg: str):
    raise SystemExit(f"transcribe_stream: {msg}")


def parse_args(argv: list[str]) -> dict:
    opts = {"model": None, "audio": None, "chunk_ms": 80, "right_context": 0,
            "lang": None, "device": "cuda", "diarize": None,
            "num_speakers": -1, "sub_shift_ms": 750,
            **{v: False for v in _FLAGS.values()}}
    pos = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in _VALUES:
            i += 1
            if i == len(argv):
                _refuse(f"{a} needs a value\n{USAGE}")
            key, conv = _VALUES[a]
            try:
                opts[key] = conv(argv[i])
            except ValueError:
                _refuse(f"{a}: not a number: {argv[i]!r}")
        elif a in _FLAGS:
            opts[_FLAGS[a]] = True
        elif a in ("--cpu", "--cuda"):
            opts["device"] = a[2:]
        elif a in ("--metal", "--tpu"):
            pass  # the JAX CLI's backend flags: accepted, no effect
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


def _chunk_conf(sess) -> float:
    """Min confidence over the session's most recent chunk of tokens (-1
    without per-token confidences)."""
    if not sess.token_confs:
        return -1.0
    n = len(sess.token_confs)
    k = min(n, 16)
    return float(min(sess.token_confs[n - k:]))


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
    diar = None
    if opts["diarize"]:
        from ..diarize.pipeline import DiarizePipeline

        diar = DiarizePipeline.from_gguf(
            opts["diarize"], num_speakers=opts["num_speakers"],
            sub_shift_ms=opts["sub_shift_ms"], device=opts["device"])
    # with --speaker-text the tagged transcript replaces the plain one
    plain = not (diar and opts["speaker_text"])
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
            if text and plain:
                sys.stdout.write(text)
                sys.stdout.flush()
            if diar is not None:
                diar.push_audio(audio.astype(np.float32) / 32768.0)
                if text:
                    diar.push_text(text, sess.total_audio_seconds,
                                   conf=_chunk_conf(sess))
                if opts["json"]:
                    for line in diar.drain_json():
                        print(line)
    finally:
        if f is not sys.stdin.buffer:
            f.close()

    tail = sess.finalize()
    if plain:
        sys.stdout.write(tail + "\n")
    sys.stdout.flush()

    if diar is not None:
        if tail:
            diar.push_text(tail, sess.total_audio_seconds,
                           conf=_chunk_conf(sess))
        result = diar.finalize()
        if opts["speaker_text"] or not opts["rttm"]:
            print(result.speaker_text)
        if opts["rttm"]:
            sys.stdout.write(result.rttm)
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
