"""BENCHMARK.json keeps the benchmark's contract, and every name in it has
its file: each configuration, its architecture, cell, traffic mix, traffic
kind and metric is found by name, and a run's last line has exactly the
contract's keys."""

from __future__ import annotations

import json
import re

import pytest

from portbench import core
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj"
                   r"|head|expansion|per_tok|d_model|d_ff|n_mels|channels")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.fixture(scope="module")
def bench():
    return json.loads(core.BENCH.read_text())


def test_top_level_and_command(bench):
    assert set(bench) == TOP
    assert core.BENCH.stat().st_size <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200 \
        <= 43200


def test_configs_and_cells(bench):
    configs = bench["configs"]
    assert 1 <= len(configs) <= 24
    assert len({c["name"] for c in configs}) == len(configs)
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in configs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["why"])
        assert one_line(c["source"]) and c["source"].startswith("https://")
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        assert c["name"] in used
        assert len(c["reduced"]) <= 16
        assert not [k for k in c["reduced"] if WIDTH.search(k)]
        assert (core.BENCH.parent / c["file"]).is_file()
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])


def test_metrics(bench):
    e2e, per = bench["end_to_end"], bench["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers: dict = {}
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"])
        moved = next(e for e in e2e if e["name"] == m["moves"])
        # every cell that reports this metric reports what it moves
        for c in m.get("workloads", cells):
            assert c in moved.get("workloads", cells)
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    # every cell reports setup_s, one more end-to-end and a per-layer metric
    for c in cells:
        assert len([m for m in e2e if c in m.get("workloads", [c])]) >= 2
        assert [m for m in per if c in m.get("workloads", [c])]
    # a cell whose kernel rooflines move a metric reports an mfu beside them
    for m in per:
        if "_roofline" in m["name"]:
            for c in m["workloads"]:
                assert [x for x in per if "mfu" in x["name"]
                        and x["moves"] == m["moves"]
                        and c in x.get("workloads", [c])]


def test_every_name_has_its_file(bench):
    suite = core.Suite()
    kinds = set()
    for w in bench["workloads"]:
        cell = suite.cell(w["name"])
        kinds.add(cell["traffic"]["kind"])
        # the configuration's architecture serves the cell's kind
        assert cell["traffic"]["kind"] in \
            suite.arch(cell["config"]["arch"]).KINDS
        limits = set(cell["sizes"]["limits"])
        assert {"served_faults", "text_off", "frames_off"} <= limits
        assert limits & {"max_gap", "off_best_per_mille"}
        assert limits <= {"max_gap", "off_best_per_mille", "served_faults",
                          "text_off", "frames_off"}
    for kind in kinds:
        assert hasattr(suite.kind(kind), "Run")
        assert callable(suite.kind(kind).calibration_right_context)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(suite.reader(m["name"]).read)
    assert set(suite.kernel_ops()) >= {"q8_linear", "t1_attention"}


def test_last_line_has_the_contract_keys(tiny_suite, capsys):
    line = tiny.run_cell(tiny_suite, "tiny-offline", capsys)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {"offline_audio_s_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["check"].values():
        assert set(c) == {"value", "limit"}
    assert line["correct"] is True


def test_without_a_card_there_is_no_result():
    import os
    import subprocess
    import sys

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, here or not
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "q8-r0-live",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=core.BENCH.parent, env=env,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
