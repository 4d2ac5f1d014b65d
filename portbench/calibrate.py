"""The blank bias of a run, chosen at set-up from the seed's own weights.

With random weights, how often greedy decoding emits depends steeply on
the blank's bias and moves with the seed: a bias that gives one token in
three frames for one seed gives none, or ten a frame, for another. So each
run sets the bias that brings its own model nearest the configuration's
`tokens_per_frame` (speech gives about one token every two to three
encoder frames), as the reference decodes clips of the run's own audio
in the cell's mode, and the work of a run is the same for every seed. Done in
float32 before the program is built; the program and the reference then
share the one bias tensor. The encoder and the greedy rule are the
architecture's (archs/<arch>: encoder, greedy_rates)."""

from __future__ import annotations

import numpy as np
import torch

from . import gen

GRID = np.arange(-8.0, 16.01, 0.125)


def blank_bias(arch, w: dict, conf: dict, right_context, pool: np.ndarray,
               device) -> float:
    """The grid's bias whose rate on the calibration clips (the
    configuration's `calibration_clips` clips of `calibration_s` seconds,
    spread evenly over the run's own audio pool) lies nearest
    `tokens_per_frame`; right_context None: the offline encoder."""
    n, secs = int(conf["calibration_clips"]), float(conf["calibration_s"])
    size = min(int(secs * gen.SAMPLE_RATE), len(pool))
    starts = np.linspace(0, len(pool) - size, n).astype(np.int64)
    with torch.no_grad():
        clips = [torch.from_numpy(pool[a:a + size]).to(device)
                 for a in starts]
        encs = [arch.encoder(w, conf, clip, right_context) for clip in clips]
        frames = min(e.shape[0] for e in encs)
        rates = arch.greedy_rates(w, conf, torch.stack([e[:frames]
                                                        for e in encs]), GRID)
    target = float(conf["tokens_per_frame"])
    return float(GRID[int(np.argmin(np.abs(np.log((rates + 1e-3)
                                                   / target))))])
