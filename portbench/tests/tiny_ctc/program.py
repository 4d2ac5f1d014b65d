"""The tiny CTC model's program: plain torch, a batch of files at a time,
greedy CTC (each frame's best label; a label other than the blank is
emitted where it differs from the frame before).

What a program has to provide, for the harness's shared code to drive it
(core.py, kinds/*.py, streams.py); an architecture lists the kinds it
serves (KINDS) and its program provides what those kinds call:

- every kind: `graphs.stats()["capture_seconds"]`, the seconds set-up spent
  capturing device graphs (0 where it captures none; metric
  graph_capture_s).
- offline (kinds/offline.py): `transcribe_audios(audios,
  timestamp_words=True) -> list[str]`, int16 arrays in, one text a file
  out, whose every token is a word " {seconds:.2f}w<id>" at the start of
  its encoder frame (gen.parse_text; the architecture's served_path reads
  the frames back); `offline_stats`, after each call a list with a dict
  for each batch of segments it ran, holding what the cell's readers read
  ("mel_frames" and "iterations" for decode_iters_per_frame.offline and
  mfu.offline, "encoder_seconds" and "decode_seconds" for
  offline_host_share.offline); `drop_offline_graphs()`, which frees what
  the calls captured, at the run's close.
- live and backlog (streams.py): nemotron_tpu_torch's
  `streaming.engine.BatchedEngine(program, batch_per_group=slots)` runs
  it: `start_stream(right_context=)`, `push_audio`, `end_stream`,
  `tick() -> (events, more)` with events' `stream_id`, `kind`, `text`
  and `at_sec`, `prewarm((right_context,))`, `stats()["groups"]` with
  ticks, steps, chunk_steps and chunks, and each slot record's `tokens`
  and `token_frames`.
"""

from __future__ import annotations

import torch


class _Graphs:
    @staticmethod
    def stats() -> dict:
        return {"capture_seconds": 0.0}


class Program:
    # its own constants: a program imports nothing of the reference
    hop, win, n_fft, stack = 160, 400, 512, 8

    def __init__(self, w: dict, device):
        self.w = w
        self.device = device
        self.blank = w["out_w"].shape[0] - 1
        self.graphs = _Graphs()
        self.offline_stats: list[dict] = []

    def _logits(self, audios) -> tuple[torch.Tensor, list[int]]:
        """[files, frames, vocab] of a zero-padded batch, and each file's
        own number of encoder frames."""
        n = max(len(a) for a in audios)
        x = torch.zeros(len(audios), max(n, self.win), device=self.device)
        for i, a in enumerate(audios):
            x[i, :len(a)] = torch.as_tensor(a, device=self.device) / 32768.0
        frames = x.unfold(1, self.win, self.hop) * self.w["pre.window"]
        spec = torch.fft.rfft(frames, n=self.n_fft)
        mel = torch.log((spec.real ** 2 + spec.imag ** 2)
                        @ self.w["pre.filterbank"].T + 2.0 ** -24)
        mel = mel - mel.mean(dim=-1, keepdim=True)
        t = mel.shape[1] // self.stack
        enc = mel[:, :t * self.stack].reshape(len(audios), t, -1)
        own = [(len(a) - self.win) // self.hop + 1 if len(a) >= self.win
               else 0 for a in audios]
        self.offline_stats = [{"batch": len(audios), "mel_frames": mel.shape[1],
                               "iterations": 0}]
        return enc @ self.w["out_w"].T + self.w["out_b"], \
            [m // self.stack for m in own]

    def _tokens(self, labels: list[int]) -> list[tuple[int, int]]:
        """Greedy CTC over one file's frame labels: (token, frame)."""
        out, prev = [], self.blank
        for t, lab in enumerate(labels):
            if lab != self.blank and lab != prev:
                out.append((lab, t))
            prev = lab
        return out

    def transcribe_audios(self, audios, timestamp_words: bool = False):
        if not len(audios):
            return []
        with torch.no_grad():
            logits, frames = self._logits(audios)
        labels = logits.argmax(dim=-1).tolist()
        frame_s = self.stack * self.hop / 16000
        texts = []
        for row, t in zip(labels, frames):
            words = [f" {{{f * frame_s:.2f}}}w{tok}" if timestamp_words
                     else f" w{tok}" for tok, f in self._tokens(row[:t])]
            texts.append("".join(words))
        return texts

    def drop_offline_graphs(self) -> None:
        pass
