"""Copies of the benchmark with some cells made smaller, for tools and
tests that run a cell at other sizes (portbench/tools/knee_sweep.py, the
card tests)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path


def dump(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


def shrunk(dest: Path, cells: dict) -> tuple[Path, Path]:
    """A copy of the real benchmark under dest with some cells made
    smaller: cells maps a cell to {"sizes": {...}, "traffic": {...}},
    merged into its workloads/<cell>.json and its traffic mix's file.
    Returns (BENCHMARK.json, its benchmark root)."""
    from portbench import core

    root = dest / "portbench"
    for sub in ("archs", "kinds", "metrics", "kernels", "traffic", "configs",
                "workloads"):
        shutil.copytree(core.ROOT / sub, root / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(core.BENCH.read_text())
    for name, change in cells.items():
        entry = next(w for w in bench["workloads"] if w["name"] == name)
        for sub, key in (("workloads", name), ("traffic", entry["traffic"])):
            path = root / sub / f"{key}.json"
            data = json.loads(path.read_text())
            data.update(change.get("sizes" if sub == "workloads" else sub,
                                   {}))
            dump(path, data)
    path = dest / "BENCHMARK.json"
    dump(path, bench)
    return path, root
