"""nemotron-speech-streaming's architecture: a cache-aware FastConformer
encoder (causal convolutions, rel-pos attention over a left context) and an
RNN-T decoder (a two-layer LSTM prediction net and a joint; at most 10
tokens a frame, a blank ends the frame), served by nemotron_tpu_torch's
ASRModel live, backlogged and offline.

model.py makes the weights and builds the program, reference.py is the
plain float32 reference, decoding.py the greedy rule (calibration and
judging) and counts.py the model's FLOPs. What each name below is for:
portbench/archs/__init__.py."""

from __future__ import annotations

from portbench import gen

from . import reference
from .counts import (decode_iteration_flops, frame_flops, max_seg_mel_frames,
                     offline_call_flops, stream_attention_calls,
                     stream_chunk_flops, stream_linear_calls,
                     stream_step_flops, stream_window, subsampled_len)
from .decoding import decision_blocks, decisions, greedy_rates
from .model import (has_q4_0_control, make_weights, program_model,
                    set_blank_bias)

KINDS = ("live", "backlog", "offline")


def encoder(w: dict, conf: dict, audio, right_context):
    """The reference's encoder frames of int16 audio on the device: the
    cache-aware streaming encoder at `right_context`, or with None the
    offline one (segments with full attention)."""
    if right_context is None:
        return reference.offline_encoder(w, conf["model"], audio)
    return reference.stream_encoder(w, conf["model"], audio,
                                    int(right_context))


def frame_seconds(conf: dict) -> float:
    """Audio seconds an encoder frame stands for (0.08 s: 8 mel hops)."""
    return (conf["model"]["subsampling_factor"] * reference.HOP
            / gen.SAMPLE_RATE)


def served_path(conf: dict, sample: dict) -> list[tuple[int, int]]:
    """A sample's (token, encoder frame) pairs in emission order: a
    stream's from the engine's record, a file's from its text, whose word
    timestamps (model.vocabulary: one word a token) give the frames."""
    if sample["kind"] == "stream":
        return sample["served"]
    ids, secs = gen.parse_text(sample["text"])
    frame = frame_seconds(conf)
    return [(t, int(round(s / frame))) for t, s in zip(ids, secs)]


__all__ = [
    "KINDS", "decision_blocks", "decisions", "decode_iteration_flops",
    "encoder", "frame_flops", "frame_seconds", "greedy_rates",
    "has_q4_0_control", "make_weights", "max_seg_mel_frames",
    "offline_call_flops", "program_model", "served_path", "set_blank_bias",
    "stream_attention_calls", "stream_chunk_flops", "stream_linear_calls",
    "stream_step_flops", "stream_window", "subsampled_len"]
