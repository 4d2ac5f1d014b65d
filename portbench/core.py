"""The harness: one run of one cell.

Everything that belongs to one configuration, cell, traffic mix, metric or
kernel is a file of its own, found by the name BENCHMARK.json gives it:

    configs/<config>.json      widths and types (BENCHMARK "file"); "arch"
                               names its architecture
    archs/<arch>/              a package: the architecture's weights,
                               program, plain reference, greedy rule and
                               model counts (archs/__init__.py lists them)
    workloads/<cell>.json      the cell's sizes and limits
    traffic/<traffic>.json     the mix's parameters; "kind" names its module
    kinds/<kind>.py            drives the program with that kind of traffic;
                               calibration_right_context(mix) names the
                               encoder mode the blank's bias is set in
    metrics/<metric>.py        read(rec) -> number, or None where it has none
    kernels/<any>.json         {"op": ..., "patterns": [...]}: the profiler
                               kernel names that do one operation

A run: check that the cell's architecture serves its traffic kind and
that the card is there, make the weights from the seed, set the blank's
bias (calibrate.py), build the program's model, let the traffic kind set
up and warm up (set-up ends when the window opens), measure for --seconds
(with --trace 1 a stretch of the window under torch.profiler), read the
peak memory, check that no JAX module was loaded, read the metrics, free
the program, judge what it served against the architecture's plain
reference (judge.py), and print one JSON line.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCH = ROOT.parent / "BENCHMARK.json"
# top-level module names that may not be loaded in the process that
# prints a result (compared whole: nemotron_tpu_torch is not nemotron_tpu)
FORBIDDEN = ("jax", "jaxlib", "flax", "nemotron_tpu")


def forbidden_modules(names) -> list[str]:
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def load_module(path: Path):
    """A module from a file of the benchmark, by path (its name may hold
    dots, as a metric's does)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_file_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_package(path: Path):
    """A directory of the benchmark as a package, by path, so that its
    modules import each other relatively; loaded once a process under a
    name made from the path."""
    name = "portbench_pkg_" + re.sub(r"\W", "_", str(path.resolve()))
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, path / "__init__.py", submodule_search_locations=[str(path)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


class Suite:
    """BENCHMARK.json and the files it names."""

    def __init__(self, bench: Path = BENCH, root: Path = ROOT):
        self.bench_path = Path(bench)
        self.root = Path(root)
        self.bench = read_json(self.bench_path)

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.bench_path}")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return read_json(self.bench_path.parent / c["file"])
        raise KeyError(f"no config {name!r} in {self.bench_path}")

    def cell(self, name: str) -> dict:
        """The cell's entry with its files: "config", "traffic" (the mix's
        parameters) and "sizes" (workloads/<cell>.json)."""
        entry = self.workload(name)
        return {"name": name, "entry": entry,
                "config": self.config(entry["config"]),
                "traffic": read_json(self.root / "traffic"
                                     / f"{entry['traffic']}.json"),
                "sizes": read_json(self.root / "workloads" / f"{name}.json")}

    def kind(self, kind: str):
        return load_module(self.root / "kinds" / f"{kind}.py")

    def arch(self, arch: str):
        return load_package(self.root / "archs" / arch)

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of `cell` reports: the end-to-end ones with
        --trace 0, the per-layer ones with --trace 1; a metric with a
        "workloads" list only in those cells."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return load_module(self.root / "metrics" / f"{metric}.py")

    def kernel_ops(self) -> dict:
        """op -> the patterns of every kernels/*.json that names it."""
        ops: dict = {}
        for path in sorted((self.root / "kernels").glob("*.json")):
            spec = read_json(path)
            ops.setdefault(spec["op"], []).extend(spec["patterns"])
        return ops


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", nargs="?", const="fp8",
                    choices=("fp8", "q4_0"),
                    help="fp8 (the default): the control, the reference "
                         "in fp8 in the program's place (judge.py), whose "
                         "`correct` has to come out false; q4_0: the "
                         "program's own Q4_0 path, where the "
                         "architecture has one for the configuration "
                         "(archs/<arch>: has_q4_0_control), read beside "
                         "it")
    return ap.parse_args(argv)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not readable"


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv, t_start: float, suite: Suite | None = None,
         device: str = "cuda") -> int:
    """One run; returns the exit code. `device="cpu"` skips the look for a
    card (the CPU tests at a tiny size)."""
    import torch

    args = parse_args(argv)
    suite = suite or Suite()
    cell = suite.cell(args.workload)
    conf, mix = cell["config"], cell["traffic"]
    arch = suite.arch(conf["arch"])
    if mix["kind"] not in arch.KINDS:
        say(f"no result: cell {cell['name']} sends {mix['kind']} traffic, "
            f"which architecture {conf['arch']} does not serve")
        return 2
    chips = int(cell["entry"]["chips"])
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            say(f"no result: the cell needs {chips} CUDA card(s), "
                f"torch sees {torch.cuda.device_count()}")
            return 2
        say(f"card: {card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one busy thread: the traffic loop; no pool of host threads beside it
    torch.set_num_threads(1)

    from . import calibrate, gen, judge

    rec: dict = {"cell": cell, "arch": arch, "seed": args.seed,
                 "seconds": args.seconds, "trace": bool(args.trace),
                 "device": device, "kernel_ops": suite.kernel_ops()}
    weights = arch.make_weights(conf, args.seed, device)
    kind = suite.kind(mix["kind"])
    bias = calibrate.blank_bias(
        arch, weights, conf, kind.calibration_right_context(mix),
        gen.mix_pool(mix, args.seed, device), device)
    arch.set_blank_bias(weights, bias)
    say(f"blank bias {bias} (calibrate.py)")
    if args.control == "q4_0" and not arch.has_q4_0_control(conf):
        say(f"no result: architecture {conf['arch']} has no q4_0 control "
            f"on this configuration")
        return 2
    model = arch.program_model(conf, weights, device,
                               q4_0=args.control == "q4_0")
    run = kind.Run(model, rec)
    run.setup()
    rec["graph_capture_s"] = model.graphs.stats()["capture_seconds"]
    # what set-up made lives to the end: the collector need not walk it
    gc.collect()
    gc.freeze()
    rec["setup_s"] = time.perf_counter() - t_start
    rec["t_window"] = time.perf_counter()
    run.window()
    if device == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    else:
        peak = 0
    bad = forbidden_modules(list(sys.modules))
    if bad:
        say(f"no result: modules of JAX or the JAX package were loaded: {bad}")
        return 3

    metrics = {}
    for m in suite.metrics(cell["name"], bool(args.trace)):
        value = suite.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    samples = run.samples()
    attempted, failed = rec["attempted"], rec["failed"]
    run.close()
    del run, model
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = judge.judge(arch, weights, cell, samples, say, device,
                          control=args.control == "fp8")
    say(f"reference: {len(samples)} samples, "
        f"{time.perf_counter() - t_ref:.2f} s")
    correct = all(v["value"] <= v["limit"] for v in numbers.values())

    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name() if device == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if args.trace and rec.get("profile"):
        prof = rec["profile"]
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["check"] = numbers
    for name, v in numbers.items():
        say(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0
