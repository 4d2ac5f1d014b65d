"""Whether what the timed path served is correct.

For each sample (finished streams, or transcribed files, drawn from the
seed with the longest among them) the reference (portbench/reference)
encodes the audio itself and follows the served tokens through the joint.
The numbers compared, each against the cell's limit (workloads/<cell>.json
"limits"):

- max_gap: over every decision the program made (each token it served, and
  each blank that ended a frame), the widest gap by which the reference's
  logit of that choice lies below the reference's best logit;
- off_best_per_mille: the decisions whose choice is not the reference's
  best, per thousand decisions;
- served_faults: samples whose served sequence is no RNN-T path (a frame
  out of range or out of order, more than 10 tokens a frame, a token
  outside the vocabulary), or no sample at all;
- text_off: streams whose event text reads back to other tokens than the
  engine's record of what it served;
- frames_off: frames by which a stream's final decode position differs
  from the frames its audio gives.

A cell compares the numbers its limits name (a number whose sound runs
and control do not read apart is left out there, and printed only).
The control puts the reference itself, computed in fp8 (every matmul's and
convolution's operands rounded to float8 e4m3 with a per-tensor scale),
the step below the bf16 arithmetic that both configurations state, in the
program's place: at every decision of the same served paths, the numbers
read the choice the fp8 copy puts first. (The program's own quantized
paths keep bf16 arithmetic: its Q4_0 weights read only 2x the sound runs'
gaps at right context 13, whose attention runs in bf16.)
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import asr as ref

FRAME_S = 0.08
FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _encode(w, hp, s, audio):
    if s["kind"] == "stream":
        return ref.stream_encoder(w, hp, audio, s["right_context"])
    return ref.offline_encoder(w, hp, audio)


def judge(weights: dict, cell: dict, samples: list[dict], say,
          control: bool = False) -> dict:
    hp = cell["config"]["model"]
    limits = cell["sizes"]["limits"]
    dev = weights["pos_table"].device
    low = dict(weights, _round=fp8) if control else None
    faults = 0 if samples else 1
    text_off = frames_off = 0
    judged = []  # (enc, enc of the fp8 copy or None, decisions, tokens)
    with torch.no_grad():
        for s in samples:
            audio = torch.from_numpy(np.ascontiguousarray(s["audio"])).to(dev)
            enc = _encode(weights, hp, s, audio)
            if s["kind"] == "stream":
                if s["text_tokens"] != [t for t, _ in s["served"]]:
                    text_off += 1
                if s["end_pos"] >= 0:
                    frames_off += abs(int(round(s["end_pos"] / FRAME_S))
                                      - enc.shape[0])
            points, why = ref.decisions(hp, enc.shape[0], s["served"])
            if why:
                faults += 1
                say(f"served fault ({s['kind']}, {len(s['audio'])} samples): "
                    f"{'; '.join(why)}")
                continue
            judged.append((enc, None if low is None
                           else _encode(low, hp, s, audio), points,
                           [t for t, _ in s["served"]]))
        max_gap, n_dec, n_off = 0.0, 0, 0
        if judged:
            seqs = [j[3] for j in judged]
            preds = ref.prediction_outputs(weights, hp, seqs, dev)
            preds_low = (None if low is None
                         else ref.prediction_outputs(low, hp, seqs, dev))
            for k, (enc, enc_low, (t_idx, u_idx, choice), _) in \
                    enumerate(judged):
                n_dec += len(choice)
                blocks = ref.joint_logits(weights, enc, preds[k], t_idx, u_idx)
                lows = (None if low is None else ref.joint_logits(
                    low, enc_low, preds_low[k], t_idx, u_idx))
                start = 0
                for logits in blocks:
                    n = logits.shape[0]
                    pick = (torch.as_tensor(choice[start:start + n],
                                            device=dev)[:, None]
                            if lows is None else
                            next(lows).argmax(dim=-1, keepdim=True))
                    gap = logits.max(dim=-1).values - logits.gather(1, pick)[:, 0]
                    max_gap = max(max_gap, float(gap.max()))
                    n_off += int((gap > 0).sum())
                    start += n
    say(f"judged {len(samples)} samples: "
        f"{sum(len(j[3]) for j in judged)} tokens, {n_dec} decisions"
        + ("" if low is None else ", read by the fp8 reference"))
    numbers = {"max_gap": max_gap,
               "off_best_per_mille": 1000.0 * n_off / max(1, n_dec),
               "served_faults": faults, "text_off": text_off,
               "frames_off": frames_off}
    for k, v in numbers.items():
        if k not in limits:
            say(f"not compared in this cell: {k} {v!r}")
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()
            if k in limits}
