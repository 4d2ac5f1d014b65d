"""The reader of the program's offline spans
(metrics/offline_host_share.offline.py): a number on the tiny traced
offline cell, the traced call left out of a window's calls, and None
where the program's stats carry no span seconds."""

from __future__ import annotations

import json

import pytest

from portbench import core
from portbench.tests import tiny

NAME = "offline_host_share.offline"


@pytest.fixture(scope="module")
def span_suite(tmp_path_factory):
    bench_path, root = tiny.build(tmp_path_factory.mktemp("spans"))
    bench = json.loads(bench_path.read_text())
    bench["per_layer"].append({
        "name": NAME, "unit": "%", "better": "lower",
        "source": "program_span", "layer": "offline",
        "moves": "offline_audio_s_per_s", "workloads": ["tiny-offline"]})
    tiny.dump(bench_path, bench)
    return core.Suite(bench_path, root)


def test_the_traced_tiny_offline_cell_reads_a_share(span_suite, capsys):
    line = tiny.run_cell(span_suite, "tiny-offline", capsys, trace=1)
    assert line["correct"] is True
    assert 0 < line["metrics"][NAME]["value"] < 100
    # an untraced run reads no per-layer metric
    line = tiny.run_cell(span_suite, "tiny-offline", capsys, trace=0)
    assert NAME not in line["metrics"]


def seg(enc: float, dec: float) -> dict:
    return {"batch": 2, "mel_frames": 64, "iterations": 32,
            "encoder_seconds": enc, "decode_seconds": dec}


def window(traced: bool) -> dict:
    """Three calls of a window (seconds 2, 4, 2; device seconds 1.5, 1.0,
    1.0), the second traced where `traced`."""
    calls = [{"seconds": 2.0, "stats": [seg(0.5, 0.5), seg(0.25, 0.25)]},
             {"seconds": 4.0, "stats": [seg(0.5, 0.5)]},
             {"seconds": 2.0, "stats": [seg(0.25, 0.75)]}]
    return {"offline_call_s": sum(c["seconds"] for c in calls),
            "offline_stats": [s for c in calls for s in c["stats"]],
            "profile": {"calls": [calls[1]]} if traced else None}


@pytest.mark.parametrize("traced, share", [(False, 100 * (1 - 3.5 / 8)),
                                           (True, 100 * (1 - 2.5 / 4))])
def test_the_traced_call_is_left_out(span_suite, traced, share):
    read = span_suite.reader(NAME).read
    assert read(window(traced)) == pytest.approx(share)


@pytest.mark.parametrize("case", ["no calls", "only the traced call",
                                  "no span seconds"])
def test_none_without_untraced_span_seconds(span_suite, case):
    read = span_suite.reader(NAME).read
    rec = window(traced=True)
    if case == "no calls":
        rec.update(offline_call_s=0.0, offline_stats=[], profile=None)
    elif case == "only the traced call":
        rec["offline_stats"] = rec["profile"]["calls"][0]["stats"]
        rec["offline_call_s"] = 4.0
    else:  # a program whose offline_stats has no seconds
        for s in rec["offline_stats"]:
            del s["encoder_seconds"], s["decode_seconds"]
    assert read(rec) is None
