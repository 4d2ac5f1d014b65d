"""A later change adds a configuration, a cell, a traffic mix, a per-layer
metric or a kernel mapping as new files and BENCHMARK.json entries, and
edits no file that is there: the harness finds each by name."""

from __future__ import annotations

import json
import shutil

from portbench import core
from portbench.tests import tiny


def test_new_files_are_found_without_edits(tmp_path, capsys):
    bench_path, root = tiny.build(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads(bench_path.read_text())
    # a configuration, a traffic mix of an existing kind, a cell on both
    cfg = json.loads((root / "configs" / "tiny-f32.json").read_text())
    cfg.update(name="tiny-f32-bias", tokens_per_frame=0.6)
    tiny.dump(root / "configs" / "tiny-f32-bias.json", cfg)
    mix = json.loads((root / "traffic" / "offline-tiny.json").read_text())
    mix.update(files=2, length_s=[2.0, 3.0])
    tiny.dump(root / "traffic" / "offline-pair.json", mix)
    tiny.dump(root / "workloads" / "tiny-offline-pair.json",
              {"limits": tiny.LIMITS})
    # a per-layer metric and a kernel mapping
    (root / "metrics" / "files_per_call.offline.py").write_text(
        "def read(rec):\n"
        "    return rec['attempted'] / max(1, len(rec['offline_stats']))\n")
    tiny.dump(root / "kernels" / "joint.json",
              {"op": "joint", "patterns": ["joint_kernel"]})
    tiny.dump(root / "kernels" / "q8_linear.extra.json",
              {"op": "q8_linear", "patterns": ["q8_new_kernel"]})
    bench["configs"].append({"name": "tiny-f32-bias", "source": "tests",
                             "file": "portbench/configs/tiny-f32-bias.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "tiny-offline-pair",
                               "config": "tiny-f32-bias",
                               "traffic": "offline-pair", "chips": 1,
                               "why": "tiny"})
    for m in bench["end_to_end"]:
        if m["name"] == "offline_audio_s_per_s":
            m["workloads"].append("tiny-offline-pair")
    bench["per_layer"].append({
        "name": "files_per_call.offline", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "offline",
        "moves": "offline_audio_s_per_s", "workloads": ["tiny-offline-pair"]})
    tiny.dump(bench_path, bench)
    for p, data in before.items():  # nothing that was there changed
        assert p.read_bytes() == data

    suite = core.Suite(bench_path, root)
    ops = suite.kernel_ops()
    assert ops["joint"] == ["joint_kernel"]
    assert "q8_new_kernel" in ops["q8_linear"] and "gemm_sm90" in \
        ops["q8_linear"]
    cell = suite.cell("tiny-offline-pair")
    assert cell["config"]["tokens_per_frame"] == 0.6
    assert cell["traffic"]["files"] == 2
    line = tiny.run_cell(suite, "tiny-offline-pair", capsys, trace=1)
    assert line["metrics"]["files_per_call.offline"]["value"] > 0
    assert line["correct"] is True
    shutil.rmtree(tmp_path / "portbench")
