"""The live cell's knee: the highest mean number of live streams at which
the 95th percentile of the emit lag stays at or below a limit (two chunk
periods, 160 ms, by default) with no growing backlog (the lag's 95th
percentile in the window's last quarter no more than 1.5 times that of its
first, or under the limit).

    python3 -m portbench.tools.knee_sweep --workload q8-r0-live \\
        --streams 1024 1536 2048 3072 4096 --seed 1 --seconds 10 \\
        [--out knee.json]

Each point is a run of the cell (one process, as the benchmark runs it)
with the cell's streams set to the point and its slots to the next
multiple of 256 at or above streams + 4 sqrt(streams); the suite of a
point is written under .portbench_cache/ in the checkout."""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

from portbench import core, variants


def slots_for(streams: int) -> int:
    return int(math.ceil((streams + 4 * math.sqrt(streams)) / 256) * 256)


def point(workload: str, streams: int, seed: int, seconds: float,
          limit_ms: float) -> dict:
    dest = core.BENCH.parent / ".portbench_cache" / "sweep" / str(streams)
    if dest.exists():
        import shutil

        shutil.rmtree(dest)
    slots = slots_for(streams)
    bench, root = variants.shrunk(dest, {workload: {
        "sizes": {"streams": streams, "slots": slots}}})
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "portbench.tools.knee_sweep", "--child",
         str(bench), str(root), "--workload", workload, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", "0"],
        capture_output=True, text=True, cwd=core.BENCH.parent)
    row = {"streams": streams, "slots": slots, "rc": out.returncode,
           "seconds": round(time.perf_counter() - t, 1)}
    if out.returncode != 0:
        row["error"] = out.stderr[-2000:]
        return row
    line = json.loads(out.stdout.strip().splitlines()[-1])
    row["emit_lag_p95_ms"] = line["metrics"]["emit_lag_p95_ms"]["value"]
    row["setup_s"] = line["metrics"]["setup_s"]["value"]
    row["correct"] = line["correct"]
    row["attempted"], row["failed"] = line["attempted"], line["failed"]
    row["memory_peak_bytes"] = line["device"]["memory_peak_bytes"]
    m = re.search(r"lag p95 by quarter of the window: (.*) ms", out.stderr)
    q = [float(x) for x in m.group(1).split()] if m else []
    row["lag_p95_quarters_ms"] = q
    row["growing"] = bool(q) and q[-1] > max(limit_ms, 1.5 * q[0])
    row["holds"] = (row["emit_lag_p95_ms"] <= limit_ms and not row["growing"]
                    and row["failed"] == 0)
    return row


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--child":
        return core.main(argv[3:], time.perf_counter(),
                         suite=core.Suite(Path(argv[1]), Path(argv[2])))
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="q8-r0-live")
    ap.add_argument("--streams", type=int, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--limit-ms", type=float, default=160.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = []
    for n in args.streams:
        rows.append(point(args.workload, n, args.seed, args.seconds,
                          args.limit_ms))
        print(json.dumps(rows[-1]), flush=True)
    held = [r["streams"] for r in rows if r.get("holds")]
    knee = max(held) if held else None
    result = {"card": core.card_line(), "workload": args.workload,
              "limit_ms": args.limit_ms, "points": rows, "knee": knee,
              "chosen": None if knee is None else int(0.8 * knee)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
