"""Batch transcription of recordings, closed loop: one caller sends
ASRModel.transcribe_audios a batch of files and waits for it, then sends
the next.

Each call holds `files` files whose lengths are the stratified quantiles of
a log-uniform range (every call the same set of lengths, in an order drawn
from the seed, with other audio), so every call is the same work; the API
splits a file longer than its segment as users get it. Set-up makes two
calls, which warm up and capture every graph key a call reaches. The
window's calls are those that start before it closes; the rate is their
audio over the time they took. Text comes with word timestamps, which the
cell's architecture reads back to the tokens and frames served
(archs/<arch>: served_path).
"""

from __future__ import annotations

import numpy as np

from portbench import gen
from portbench.streams import clock
from portbench.trace import Stretch, span


def calibration_right_context(mix: dict) -> None:
    """The encoder mode the blank's bias is set in (calibrate.py): None,
    the offline encoder."""
    return None


class Run:
    def __init__(self, model, rec: dict):
        self.model = model
        self.rec = rec
        self.mix = rec["cell"]["traffic"]
        self.seed = rec["seed"]
        self.files = int(self.mix["files"])
        lo, hi = self.mix["length_s"]
        self.r = gen.rng(self.seed, "offline")
        self.lengths = (gen.log_uniform(gen.quantiles(self.files, self.r),
                                        lo, hi) * gen.SAMPLE_RATE
                        ).astype(np.int64)
        self.pool = gen.mix_pool(self.mix, self.seed, self.rec["device"])
        self.calls: list[dict] = []
        rec["shape"] = {"files": self.files,
                        "hp": rec["cell"]["config"]["model"]}

    def _batch(self) -> list[dict]:
        out = []
        for n in self.r.permutation(self.lengths):
            off = int(self.r.random() * (len(self.pool) - n))
            out.append({"offset": off, "n": int(n)})
        return out

    def _call(self, batch: list[dict]) -> dict:
        audios = [self.pool[f["offset"]:f["offset"] + f["n"]] for f in batch]
        t = clock()
        with span("call"):
            texts = self.model.transcribe_audios(audios, timestamp_words=True)
        return {"batch": batch, "texts": texts, "seconds": clock() - t,
                "stats": list(self.model.offline_stats)}

    def setup(self) -> None:
        for _ in range(2):
            self._call(self._batch())

    def window(self) -> None:
        rec = self.rec
        t0 = rec["t_window"]
        t1 = t0 + float(rec["seconds"])
        trace = rec["trace"]
        while clock() < t1:
            traced = trace and clock() >= t0 + float(rec["seconds"]) / 3
            if traced:
                stretch = Stretch(self._sync)
                stretch.start()
            call = self._call(self._batch())
            if traced:
                prof = stretch.stop()
                if prof is not None:
                    prof["calls"] = [call]
                rec["profile"] = prof
                trace = False
            self.calls.append(call)
        rec["window_s"] = clock() - t0
        audio = sum(f["n"] for c in self.calls for f in c["batch"])
        rec["offline_audio_s"] = audio / gen.SAMPLE_RATE
        rec["offline_call_s"] = sum(c["seconds"] for c in self.calls)
        rec["offline_stats"] = [s for c in self.calls for s in c["stats"]]
        rec["attempted"] = sum(len(c["batch"]) for c in self.calls)
        rec["failed"] = 0  # a call that fails raises: the run gives no line

    def _sync(self) -> None:
        if self.rec["device"] == "cuda":
            import torch

            torch.cuda.synchronize()

    def samples(self) -> list[dict]:
        """`sample_files` of the window's files drawn from the seed, the
        longest among them."""
        files = [(f, text) for c in self.calls
                 for f, text in zip(c["batch"], c["texts"])]
        if not files:
            return []
        r = gen.rng(self.seed, "sample")
        longest = max(range(len(files)), key=lambda i: files[i][0]["n"])
        rest = [i for i in r.permutation(len(files)) if i != longest]
        out = []
        for i in [longest] + rest[:int(self.mix["sample_files"]) - 1]:
            f, text = files[i]
            out.append({"kind": "file",
                        "audio": self.pool[f["offset"]:f["offset"] + f["n"]],
                        "text": text})
        return out

    def close(self) -> None:
        self.model.drop_offline_graphs()
        self.model = None
