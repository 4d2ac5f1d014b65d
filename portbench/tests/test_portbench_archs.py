"""Architectures as files of their own (portbench/archs/).

nemotron's architecture (archs/fastconformer_rnnt) computes what the
harness computed before it had architectures: the same weights for a seed,
the same blank bias for each tiny cell, the same numbers from the judge,
pinned here as that harness read them on the CPU.

A second architecture comes as new files only: the tiny greedy CTC model
of portbench/tests/tiny_ctc, copied with its configuration and cells into
a tiny benchmark in which every file that was there keeps its bytes, runs
its offline cell correct, is not correct with a token of its program
altered, and stops at set-up in a cell whose traffic kind it does not
serve."""

from __future__ import annotations

import hashlib
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import calibrate, core, gen, judge
from portbench.archs import fastconformer_rnnt as arch
from portbench.archs.fastconformer_rnnt import reference as ref
from portbench.tests import tiny

CELL_SEED = 4294967311
# sha256 of every tensor of make_weights(conf, seed, "cpu") (checksum())
WEIGHTS = {
    ("tiny-q8", 3):
        "79e8b1431c280eaffb2eb5657a09a9405c1f61cbf63176bb64e10ee1bd762556",
    ("tiny-q8", 2 ** 33 + 17):
        "b0da165283ac4e61ec267d30c9ed640e5129c0a158491a072570c03a91c8405f",
    ("tiny-f32", 3):
        "310ab120140495bac879896e4d2330211a3284c6cae69b15ca4a1f63117ceb89",
    ("tiny-f32", 2 ** 33 + 17):
        "5e53083c4829df7f34a6a9ed4b7b47d720f8e0f7be4683670bb1b42ec0e17644",
}
# calibrate.blank_bias at CELL_SEED
BIAS = {"tiny-live": 3.375, "tiny-backlog": 3.5, "tiny-offline": 4.125}
# judge.judge on fixed_samples(), the blank's bias 2.0, seed 3
JUDGED = {
    ("tiny-q8", False): {"max_gap": 4.259763717651367,
                         "off_best_per_mille": 626.2135922330098,
                         "served_faults": 1, "text_off": 1, "frames_off": 4},
    ("tiny-q8", True): {"max_gap": 0.6850118637084961,
                        "off_best_per_mille": 111.6504854368932,
                        "served_faults": 1, "text_off": 1, "frames_off": 4},
    ("tiny-f32", False): {"max_gap": 4.245420932769775,
                          "off_best_per_mille": 626.2135922330098,
                          "served_faults": 1, "text_off": 1, "frames_off": 4},
    ("tiny-f32", True): {"max_gap": 0.690860390663147,
                         "off_best_per_mille": 126.2135922330097,
                         "served_faults": 1, "text_off": 1, "frames_off": 4},
}
CTC_DIR = Path(__file__).resolve().parent / "tiny_ctc"
CTC_CONFIG = {"name": "tiny-ctc", "arch": "tiny_ctc",
              "model": {"n_mels": 16, "vocab_size": 33},
              "activations": "float32", "tokens_per_frame": 0.4,
              "calibration_s": 1, "calibration_clips": 4}


def checksum(w: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(w):
        v = w[k]
        parts = ([("codes", v["codes"]), ("scales", v["scales"])]
                 if isinstance(v, dict) else [("", v)])
        for sub, t in parts:
            t = t.detach().cpu().contiguous()
            h.update(f"{k}.{sub}:{t.dtype}:{tuple(t.shape)}".encode())
            h.update(t.numpy().tobytes())
    return h.hexdigest()


def fixed_samples(hp: dict) -> list[dict]:
    """Two streams (R=0, R=1), a file and a stream whose path leaves its
    frames, each with a path drawn from a fixed generator; the R=1
    stream's text reads one token off, and the streams' final positions
    0, 1 and 3 frames past their audio."""
    pool = gen.audio_pool(6.0, 11, "cpu")
    r = np.random.default_rng(5)
    out = []
    for i, (kind, rc, a, n) in enumerate((("stream", 0, 0, 40000),
                                          ("stream", 1, 8000, 56000),
                                          ("file", None, 16000, 80000),
                                          ("stream", 0, 4000, 30000))):
        frames = (ref.stream_frames(hp, rc, n) if kind == "stream" else
                  ref.subsampled_len(ref.mel_frames_available(n)))
        k = frames // 2
        at = np.sort(r.integers(0, frames, k))
        tok = r.integers(0, hp["vocab_size"] - 1, k)
        path = [(int(t), int(f)) for t, f in zip(tok, at)]
        if i == 3:
            path.append((1, frames))
        s = {"kind": kind, "audio": pool[a:a + n]}
        if kind == "stream":
            text = [t for t, _ in path]
            if i == 1:
                text[0] = (text[0] + 1) % (hp["vocab_size"] - 1)
            s.update(right_context=rc, served=path, text_tokens=text,
                     end_pos=(frames + i) * 0.08)
        else:
            s["text"] = "".join(f" {{{f * 0.08:.2f}}}w{t}" for t, f in path)
        out.append(s)
    return out


@pytest.mark.parametrize("config, seed", list(WEIGHTS))
def test_weights_are_the_same_as_before(tiny_suite, config, seed):
    w = arch.make_weights(tiny_suite.config(config), seed, "cpu")
    assert checksum(w) == WEIGHTS[(config, seed)]


@pytest.mark.parametrize("cell", list(BIAS))
def test_blank_bias_is_the_same_as_before(tiny_suite, cell):
    c = tiny_suite.cell(cell)
    mix = c["traffic"]
    w = arch.make_weights(c["config"], CELL_SEED, "cpu")
    kind = tiny_suite.kind(mix["kind"])
    assert calibrate.blank_bias(
        tiny_suite.arch(c["config"]["arch"]), w, c["config"],
        kind.calibration_right_context(mix),
        gen.mix_pool(mix, CELL_SEED, "cpu"), "cpu") == BIAS[cell]


@pytest.mark.parametrize("config, control", list(JUDGED))
def test_judge_reads_the_same_numbers_as_before(tiny_suite, config, control):
    conf = tiny_suite.config(config)
    w = arch.make_weights(conf, 3, "cpu")
    arch.set_blank_bias(w, 2.0)
    cell = {"config": conf, "sizes": {"limits": dict.fromkeys(
        JUDGED[(config, control)], 1e9)}}
    numbers = judge.judge(tiny_suite.arch(conf["arch"]), w, cell,
                          fixed_samples(conf["model"]), lambda _: None,
                          "cpu", control=control)
    assert {k: v["value"] for k, v in numbers.items()} == \
        JUDGED[(config, control)]


@pytest.fixture(scope="module")
def ctc(tmp_path_factory):
    """A tiny benchmark, then the CTC architecture added to it as files:
    (suite, the bytes of every file the benchmark had)."""
    dest = tmp_path_factory.mktemp("ctc")
    bench_path, root = tiny.build(dest)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    shutil.copytree(CTC_DIR, root / "archs" / "tiny_ctc",
                    ignore=shutil.ignore_patterns("__pycache__"))
    tiny.dump(root / "configs" / "tiny-ctc.json", CTC_CONFIG)
    for cell in ("tiny-ctc-offline", "tiny-ctc-backlog"):
        tiny.dump(root / "workloads" / f"{cell}.json",
                  {"slots": 4, "limits": tiny.LIMITS})
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "tiny-ctc", "source": "tests",
                             "file": "portbench/configs/tiny-ctc.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"] += [
        {"name": "tiny-ctc-offline", "config": "tiny-ctc",
         "traffic": "offline-tiny", "chips": 1, "why": "tiny"},
        {"name": "tiny-ctc-backlog", "config": "tiny-ctc",
         "traffic": "backlog-tiny", "chips": 1, "why": "tiny"}]
    reported = {"offline_audio_s_per_s": "tiny-ctc-offline",
                "stream_audio_s_per_s": "tiny-ctc-backlog"}
    for m in bench["end_to_end"]:
        if m["name"] in reported:
            m["workloads"].append(reported[m["name"]])
    bench["per_layer"].append({
        "name": "mfu.offline", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "model step",
        "moves": "offline_audio_s_per_s", "workloads": ["tiny-ctc-offline"]})
    tiny.dump(bench_path, bench)
    return core.Suite(bench_path, root), before


def test_a_second_architecture_is_added_as_files(ctc, capsys):
    suite, before = ctc
    for p, data in before.items():  # nothing that was there changed
        assert p.read_bytes() == data
    line = tiny.run_cell(suite, "tiny-ctc-offline", capsys)
    assert line["correct"] is True, line["check"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["check"]["max_gap"]["value"] < 1e-4


def test_its_program_with_a_token_altered_is_not_correct(ctc, capsys,
                                                         monkeypatch):
    suite, _ = ctc
    program = suite.arch("tiny_ctc").program.Program
    orig = program._tokens

    def altered(self, labels):
        out = orig(self, labels)
        if out:
            tok, f = out[0]
            out[0] = ((tok + 1) % self.blank, f)
        return out

    monkeypatch.setattr(program, "_tokens", altered)
    line = tiny.run_cell(suite, "tiny-ctc-offline", capsys)
    assert line["correct"] is False, line["check"]


def test_a_kind_it_does_not_serve_stops_at_setup(ctc, capsys):
    suite, _ = ctc
    argv = ["--workload", "tiny-ctc-backlog", "--seed", "7", "--seconds",
            "2", "--trace", "0"]
    assert core.main(argv, time.perf_counter(), suite=suite,
                     device="cpu") == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "tiny-ctc-backlog" in out.err and "backlog" in out.err


def test_mfu_offline_reads_the_cells_architecture(ctc):
    """mfu.offline, with no reader of the CTC model's own, counts its
    linear layer: files of 16,000 and 32,000 samples have 98 and 198 mel
    frames, 12 and 24 encoder frames of 2 x 128 x 33 FLOPs."""
    suite, _ = ctc
    rec = {"arch": suite.arch("tiny_ctc"),
           "shape": {"hp": CTC_CONFIG["model"]},
           "profile": {"window_s": 1e-3, "calls": [
               {"batch": [{"n": 16000}, {"n": 32000}],
                "stats": [{"iterations": 0}]}]}}
    flops = 36 * 2 * 128 * 33
    assert suite.reader("mfu.offline").read(rec) == pytest.approx(
        100.0 * flops / 1e-3 / 989e12)


def test_the_ctc_reference_agrees_with_its_program():
    """The CTC program and its plain reference, logit for logit, on files
    of other lengths in one batch."""
    from portbench.tests import tiny_ctc

    w = tiny_ctc.make_weights(CTC_CONFIG, 9, "cpu")
    pool = gen.audio_pool(3.0, 4, "cpu")
    audios = [pool[:20000], pool[5000:41000]]
    prog = tiny_ctc.program_model(CTC_CONFIG, w, "cpu")
    with torch.no_grad():
        logits, frames = prog._logits(audios)
        for i, a in enumerate(audios):
            mine = tiny_ctc.reference.logits(
                w, tiny_ctc.encoder(w, CTC_CONFIG, torch.from_numpy(a), None))
            assert mine.shape[0] == frames[i] > 0
            np.testing.assert_allclose(logits[i, :frames[i]].numpy(),
                                       mine.numpy(), atol=1e-4, rtol=0)
