"""Time kernels B4 / B5 (Q8_0 / Q4_0 linears, bf16 activations) of two or
more checkouts of the repo in turns on one card, as one call of the card
allows a fair comparison: each tree runs in a process of its own (it
builds its own kernels into its own `_build/`), in the order given, e.g.
parent, change, change, parent.

    python3 nemotron_tpu_torch/tools/gemm_turns.py \\
        --tree parent=_archive/parent --tree change=. \\
        --tree change=. --tree parent=_archive/parent [--probe]

Per tree and case: device ms per call (CUDA events around 50 calls behind
a device spin, median of 7), and `dense_ms`, torch.matmul of x and the
weight dequantized to bf16 beforehand (cuBLAS's dense product of the same
shape). The cases are the main path's (N, K) at M in {32, 141, 256}.
`--probe` then times the change's kernels built as measurement variants
of csrc/wq_gemm_sm90.cuh (WQ_SM90_PROBE: without the dequantization,
without the wgmma, without both; WQ_SM90_MAX_STAGES: a deeper ring), each
on ops/quant.py:gemm_plan's plan, with one more case of a single pipeline
step (K = 64) for the fixed cost of a call. Their outputs are not the
function's. Prints one line per case; `--json PATH` also writes all of it
there as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

SHAPES = ((4096, 1024), (1024, 4096), (2048, 1024), (1024, 1024))
BATCHES = (32, 141, 256)


def cuda_ms(torch, fn, launches: int = 50, repeats: int = 7) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)  # keep the device busy while enqueuing
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


# measurement variants of the change's kernels: label, extra nvcc flags
PROBES = (
    ("probe: full", ()),
    ("probe: no dequant", ("-DWQ_SM90_PROBE=1",)),
    ("probe: no wgmma", ("-DWQ_SM90_PROBE=2",)),
    ("probe: neither", ("-DWQ_SM90_PROBE=3",)),
    ("probe: 8 stages", ("-DWQ_SM90_MAX_STAGES=8",)),
    ("probe: 8 stages, neither",
     ("-DWQ_SM90_MAX_STAGES=8", "-DWQ_SM90_PROBE=3")),
)
ONE_STEP = (1024, 64)  # (N, K) of a single pipeline step, one split


def child(tree: str, flags: list[str], probe: bool) -> None:
    """Runs inside `tree`: times its B4 / B5, built with the extra nvcc
    `flags`, and prints one JSON line. A probe's rows carry the plan, and
    it adds the single-step case."""
    sys.path.insert(0, tree)
    import torch

    from nemotron_tpu_torch import kernels
    from nemotron_tpu_torch.ops import quant

    kernels.NVCC_FLAGS = (*kernels.NVCC_FLAGS, *flags)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    rows = []
    for bits in (8, 4):
        qz = quant.quantize_q8 if bits == 8 else quant.quantize_q4
        fn = quant.linear_q8 if bits == 8 else quant.linear_q4
        deq = quant.dequantize if bits == 8 else quant.dequantize_q4
        for n, k in SHAPES + ((ONE_STEP,) if probe else ()):
            qt = qz((rng.standard_normal((n, k)) / np.sqrt(k)).astype(
                np.float32)).to(dev)
            wt = deq(qt, torch.bfloat16)  # [N, K] bf16, once
            for m in BATCHES:
                x = torch.tensor(rng.standard_normal((m, k)).astype(
                    np.float32), device=dev).to(torch.bfloat16)
                row = dict(bits=bits, m=m, n=n, k=k,
                           ms=cuda_ms(torch, lambda: fn(x, qt)),
                           dense_ms=cuda_ms(torch,
                                            lambda: torch.matmul(x, wt.T)))
                if probe:
                    p = quant.gemm_plan(m, n, k, bits, sms)
                    row.update(m_tile=p.m_tile, splits=p.splits,
                               steps_per=p.steps_per)
                rows.append(row)
    print(json.dumps({"rows": rows}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="label=path, in the order to run")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--json", help="write every run's rows here as JSON")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--flag", action="append", default=[],
                    help=argparse.SUPPRESS)
    ap.add_argument("--child-probe", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.flag, args.child_probe)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = [(t.split("=", 1)[0], t.split("=", 1)[1], None)
            for t in args.tree]
    change = next((p for lbl, p, _ in runs if lbl == "change"), None)
    if args.probe and change:
        runs += [(label, change, flags) for label, flags in PROBES]
    out = []
    for label, path, flags in runs:
        cmd = [sys.executable, os.path.abspath(__file__),
               "--child", os.path.abspath(path)]
        if flags is not None:
            cmd += ["--child-probe", *(f"--flag={f}" for f in flags)]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             cwd=os.path.abspath(path), timeout=900)
        if res.returncode != 0:
            print(f"{label}: failed\n{res.stderr[-3000:]}", flush=True)
            return 1
        got = json.loads(res.stdout.strip().splitlines()[-1])
        out.append(dict(label=label, path=path, flags=list(flags or ()),
                        **got))
        for r in got["rows"]:
            plan = (f", m_tile {r['m_tile']} splits {r['splits']} x "
                    f"{r['steps_per']} steps" if "splits" in r else "")
            print(f"{label}: q{r['bits']} M={r['m']} N={r['n']} K={r['k']}: "
                  f"{r['ms']:.4f} ms, dense {r['dense_ms']:.4f} ms{plan} "
                  f"({card})", flush=True)
    if args.json:
        dest = Path(args.json)
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text(json.dumps({"card": card, "runs": out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
