"""This architecture's model counts, from shapes: the FLOPs of a frame, a
decode iteration, a streaming chunk step and an offline call, and the
calls of one chunk step's linears and T=1 attention, which the readers
(portbench/readers.py, metrics/mfu.*) hold against the card's peaks and the
kernels' bounds in portbench/roofline.py. A model FLOP counts the work of
the model's operation, whatever kernel does it."""

from __future__ import annotations


def encoder_matrices(hp: dict) -> dict:
    """Each conformer layer's matrices: name -> (out, in)."""
    d, f = hp["d_model"], hp["d_ff"]
    return {"ffn1_w1": (f, d), "ffn1_w2": (d, f), "ffn2_w1": (f, d),
            "ffn2_w2": (d, f), "attn_q_w": (d, d), "attn_k_w": (d, d),
            "attn_v_w": (d, d), "attn_pos_w": (d, d), "attn_out_w": (d, d),
            "conv_pw1_w": (2 * d, d), "conv_pw2_w": (d, d)}


def stream_window(hp: dict, right_context: int) -> tuple[int, int]:
    """(frames a chunk, keys a query sees) of a streaming chunk."""
    chunk = 1 + right_context
    return chunk, hp["att_left_context"] + chunk


def stream_linear_calls(hp: dict, fields, slots: int, right_context: int):
    """The calls of one chunk step's linears on `fields`: [(m, n, k)], the
    positional projection on the chunk's rows of the positional table, the
    others on every slot's frames."""
    chunk, keys = stream_window(hp, right_context)
    mats = encoder_matrices(hp)
    calls = []
    for name in fields:
        n, k = mats[name]
        m = 2 * keys - 1 if name == "attn_pos_w" else slots * chunk
        calls += [(m, n, k)] * hp["n_layers"]
    return calls


def stream_attention_calls(hp: dict, slots: int, right_context: int):
    """The T=1 attention of one chunk step: (calls, (streams, heads, keys,
    head width)), one call a layer; None where a chunk holds more than one
    frame (matmul attention, no T=1 kernel)."""
    chunk, keys = stream_window(hp, right_context)
    if chunk != 1:
        return None
    return hp["n_layers"], (slots, hp["n_heads"], keys,
                            hp["d_model"] // hp["n_heads"])


def subsampling_flops(hp: dict) -> float:
    """FLOPs of the subsampling per encoder frame (its 8 mel frames)."""
    c, d = hp["subsampling_channels"], hp["d_model"]
    w1 = hp["n_mels"] // 2 + 1
    w2 = w1 // 2 + 1
    w3 = w2 // 2 + 1
    return 2.0 * (9 * c * 4 * w1 + 9 * c * 2 * w2 + c * c * 2 * w2
                  + 9 * c * w3 + c * c * w3 + w3 * c * d)


def frame_flops(hp: dict) -> float:
    """FLOPs of one encoder frame outside attention's scores: the
    subsampling, the 24 layers' matrices and depthwise convolutions, and
    the joint's encoder projection."""
    d = hp["d_model"]
    per_layer = sum(2.0 * n * k for name, (n, k) in
                    encoder_matrices(hp).items() if name != "attn_pos_w")
    per_layer += 2.0 * hp["kernel_size"] * d
    return subsampling_flops(hp) + hp["n_layers"] * per_layer \
        + 2.0 * d * hp["joint_dim"]


def attention_flops(hp: dict, queries: int, keys: int) -> float:
    """Content and position scores and the context, every layer."""
    return hp["n_layers"] * 6.0 * hp["d_model"] * queries * keys


def pos_projection_flops(hp: dict, rows: int) -> float:
    return hp["n_layers"] * 2.0 * rows * hp["d_model"] ** 2


def decode_iteration_flops(hp: dict) -> float:
    """One stream's loop iteration: the two LSTM layers, the joint's
    prediction projection and its output layer."""
    h, j, v = hp["decoder_dim"], hp["joint_dim"], hp["vocab_size"]
    return 2 * (2.0 * 4 * h * 2 * h) + 2.0 * h * j + 2.0 * j * v


def stream_chunk_flops(hp: dict, right_context: int) -> float:
    """Model FLOPs of one stream's chunk step: its frames, their attention
    over the window, and the decode loop's chunk * 11 + 1 iterations."""
    chunk, keys = stream_window(hp, right_context)
    return chunk * frame_flops(hp) + attention_flops(hp, chunk, keys) \
        + (chunk * 11 + 1) * decode_iteration_flops(hp)


def stream_step_flops(hp: dict, right_context: int) -> float:
    """Model FLOPs a chunk step does once for every stream: the
    positional projection."""
    _, keys = stream_window(hp, right_context)
    return pos_projection_flops(hp, 2 * keys - 1)


def subsampled_len(t: int) -> int:
    for _ in range(3):
        t = t // 2 + 1
    return t


def max_seg_mel_frames(hp: dict) -> int:
    """The offline API's segment: the longest mel whose subsampled length
    fits the positional table."""
    t = 8 * hp["max_pos_len"]
    while subsampled_len(t) > hp["max_pos_len"]:
        t -= 8
    return t


def mel_frames(n_samples: int) -> int:
    avail = 256 + n_samples
    return 0 if avail < 512 else (avail - 512 + 160) // 160


def offline_call_flops(hp: dict, samples: list[int], segment: int,
                       iterations: list[int]) -> float:
    """Model FLOPs of one offline call: each file's segments (mel frames,
    at most `segment` each) through the encoder with full attention over
    the segment, and the decode loop's iterations (per segment) over every
    file of the batch."""
    flops = 0.0
    b = len(samples)
    for n in samples:
        m = mel_frames(n)
        for s in range(0, m, segment):
            f = subsampled_len(min(segment, m - s))
            flops += f * frame_flops(hp) + attention_flops(hp, f, f) \
                + pos_projection_flops(hp, 2 * f - 1)
    return flops + sum(iterations) * b * decode_iteration_flops(hp)
