"""Whether what the timed path served is correct.

For each sample (finished streams, or transcribed files, drawn from the
seed with the longest among them) the cell's architecture (archs/<arch>)
reads the path the program served, its plain reference encodes the audio
itself, and its greedy rule lists the decisions the program made and the
reference's logits at each. The numbers compared, each against the cell's
limit (workloads/<cell>.json "limits"):

- max_gap: over every decision the program made, the widest gap by which
  the reference's logit of that choice lies below the reference's best
  logit;
- off_best_per_mille: the decisions whose choice is not the reference's
  best, per thousand decisions;
- served_faults: samples whose served path the architecture's rule cannot
  have made (a frame out of range or out of order, a token outside the
  vocabulary, more tokens a frame than the rule emits), or no sample at
  all;
- text_off: streams whose event text reads back to other tokens than the
  engine's record of what it served;
- frames_off: frames by which a stream's final decode position differs
  from the frames its audio gives.

A cell compares the numbers its limits name (a number whose sound runs
and control do not read apart is left out there, and printed only).
The control puts the architecture's reference itself, computed in fp8
(every matmul's and convolution's operands rounded to float8 e4m3 with a
per-tensor scale: the weight dict's "_round"), the step below the bf16
arithmetic that both configurations state, in the program's place: at
every decision of the same served paths, the numbers read the choice the
fp8 copy puts first. (The program's own quantized
paths keep bf16 arithmetic: its Q4_0 weights read only 2x the sound runs'
gaps at right context 13, whose attention runs in bf16.)
"""

from __future__ import annotations

import numpy as np
import torch

FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def judge(arch, weights: dict, cell: dict, samples: list[dict], say,
          device, control: bool = False) -> dict:
    conf = cell["config"]
    limits = cell["sizes"]["limits"]
    low = dict(weights, _round=fp8) if control else None
    frame_s = arch.frame_seconds(conf)
    faults = 0 if samples else 1
    text_off = frames_off = 0
    judged, judged_low = [], []  # (enc, path, decisions) of each side
    with torch.no_grad():
        for s in samples:
            audio = torch.from_numpy(np.ascontiguousarray(s["audio"])).to(
                device)
            rc = s["right_context"] if s["kind"] == "stream" else None
            enc = arch.encoder(weights, conf, audio, rc)
            path = arch.served_path(conf, s)
            if s["kind"] == "stream":
                if s["text_tokens"] != [t for t, _ in path]:
                    text_off += 1
                if s["end_pos"] >= 0:
                    frames_off += abs(int(round(s["end_pos"] / frame_s))
                                      - enc.shape[0])
            points, why = arch.decisions(conf, enc.shape[0], path)
            if why:
                faults += 1
                say(f"served fault ({s['kind']}, {len(s['audio'])} samples): "
                    f"{'; '.join(why)}")
                continue
            judged.append((enc, path, points))
            if low is not None:
                judged_low.append((arch.encoder(low, conf, audio, rc), path,
                                   points))
        max_gap, n_dec, n_off = 0.0, 0, 0
        if judged:
            blocks = arch.decision_blocks(weights, conf, judged, device)
            lows = (None if low is None else
                    arch.decision_blocks(low, conf, judged_low, device))
            for logits, choice in blocks:
                pick = (choice[:, None] if lows is None else
                        next(lows)[0].argmax(dim=-1, keepdim=True))
                gap = logits.max(dim=-1).values - logits.gather(1, pick)[:, 0]
                max_gap = max(max_gap, float(gap.max()))
                n_off += int((gap > 0).sum())
                n_dec += logits.shape[0]
    say(f"judged {len(samples)} samples: "
        f"{sum(len(j[1]) for j in judged)} tokens, {n_dec} decisions"
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
