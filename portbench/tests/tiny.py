"""A tiny copy of the benchmark for the CPU tests: the architectures, traffic
kinds, metrics and kernel maps of portbench/ with a BENCHMARK.json of
tiny cells (the widths of tests/helpers.tiny_hparams with d_ff 128,
activations in float32) and short mixes, whose
every finished stream and file is judged."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from portbench.variants import dump

PORTBENCH = Path(__file__).resolve().parents[1]

TINY_MODEL = {"n_mels": 32, "d_model": 64, "n_heads": 4, "d_head": 16,
              "d_ff": 128, "n_layers": 2, "kernel_size": 5, "vocab_size": 33,
              "decoder_dim": 32, "joint_dim": 32, "subsampling_factor": 8,
              "subsampling_channels": 16, "att_left_context": 8,
              "num_prompts": 0, "max_pos_len": 64}
MATRICES = ["ffn1_w1", "ffn1_w2", "ffn2_w1", "ffn2_w2", "attn_q_w",
            "attn_k_w", "attn_v_w", "attn_pos_w", "attn_out_w", "conv_pw1_w",
            "conv_pw2_w"]
LIMITS = {"max_gap": 1e-3, "served_faults": 0, "text_off": 0,
          "frames_off": 0}


def build(dest: Path) -> tuple[Path, Path]:
    """The tiny suite under dest: (BENCHMARK.json, its benchmark root)."""
    root = dest / "portbench"
    for sub in ("archs", "kinds", "metrics", "kernels"):
        shutil.copytree(PORTBENCH / sub, root / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name, quant in (("tiny-q8", MATRICES), ("tiny-f32", [])):
        dump(root / "configs" / f"{name}.json", {
            "name": name, "arch": "fastconformer_rnnt",
            "model": TINY_MODEL, "activations": "float32",
            "kv_cache": "float32", "q8_0_fields": quant,
            "tokens_per_frame": 0.4, "calibration_s": 1,
            "calibration_clips": 4})
    dump(root / "traffic" / "live-tiny.json", {
        "kind": "live", "right_context": 0, "life_s": [1.0, 3.0],
        "packet_ms": 80, "warm_s": 1.0, "drain_s": 10, "trace_s": 0.5,
        "sample_streams": 100})
    dump(root / "traffic" / "backlog-tiny.json", {
        "kind": "backlog", "right_context": 1, "life_s": [1.0, 3.0],
        "cycle": 8, "warm_s": 0.5, "trace_s": 0.5, "sample_streams": 100})
    dump(root / "traffic" / "offline-tiny.json", {
        "kind": "offline", "files": 3, "length_s": [4.0, 12.0],
        "sample_files": 100})
    dump(root / "workloads" / "tiny-live.json",
         {"streams": 4, "slots": 8, "limits": LIMITS})
    dump(root / "workloads" / "tiny-backlog.json",
         {"slots": 4, "limits": LIMITS})
    dump(root / "workloads" / "tiny-offline.json", {"limits": LIMITS})
    bench = {
        "command": ["python3", "-m", "portbench.run"],
        "paths": ["portbench"], "run_seconds": 2,
        "configs": [{"name": n, "source": "tests", "file":
                     f"portbench/configs/{n}.json", "reduced": [],
                     "why": "tiny"} for n in ("tiny-q8", "tiny-f32")],
        "workloads": [
            {"name": "tiny-live", "config": "tiny-q8", "traffic": "live-tiny",
             "chips": 1, "why": "tiny"},
            {"name": "tiny-backlog", "config": "tiny-f32",
             "traffic": "backlog-tiny", "chips": 1, "why": "tiny"},
            {"name": "tiny-offline", "config": "tiny-f32",
             "traffic": "offline-tiny", "chips": 1, "why": "tiny"}],
        "end_to_end": [
            {"name": "emit_lag_p95_ms", "unit": "ms", "better": "lower",
             "bound": 0.1, "source": "host_clock", "workloads": ["tiny-live"]},
            {"name": "stream_audio_s_per_s", "unit": "audio-s/s",
             "better": "higher", "bound": 0.1, "source": "host_clock",
             "workloads": ["tiny-backlog"]},
            {"name": "offline_audio_s_per_s", "unit": "audio-s/s",
             "better": "higher", "bound": 0.1, "source": "host_clock",
             "workloads": ["tiny-offline"]},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [
            {"name": "emit_lag_p50_ms.live", "unit": "ms", "better": "lower",
             "source": "host_clock", "layer": "engine",
             "moves": "emit_lag_p95_ms", "workloads": ["tiny-live"]},
            {"name": "engine_tick_ms.live", "unit": "ms", "better": "lower",
             "source": "host_clock", "layer": "engine",
             "moves": "emit_lag_p95_ms", "workloads": ["tiny-live"]},
            {"name": "chunk_steps_per_tick.backlog", "unit": "count",
             "better": "higher", "source": "program_counter",
             "layer": "engine", "moves": "stream_audio_s_per_s",
             "workloads": ["tiny-backlog"]},
            {"name": "graph_capture_s", "unit": "s", "better": "lower",
             "source": "program_counter", "layer": "tick and graphs",
             "moves": "setup_s"},
            {"name": "decode_iters_per_frame.offline", "unit": "count",
             "better": "lower", "source": "program_counter",
             "layer": "offline", "moves": "offline_audio_s_per_s",
             "workloads": ["tiny-offline"]}],
    }
    path = dest / "BENCHMARK.json"
    dump(path, bench)
    return path, root


def run_cell(suite, cell: str, capsys, seed: int = 4294967311,
             seconds: float = 2, trace: int = 0, device: str = "cpu",
             control: bool | str = False) -> dict:
    """One run of `cell` through core.main; returns its JSON line.
    control: True, the fp8 control; or the name of a control."""
    from portbench import core

    argv = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    if control:
        argv += ["--control"] + ([] if control is True else [control])
    rc = core.main(argv, time.perf_counter(), suite=suite, device=device)
    out = capsys.readouterr().out
    assert rc == 0, out
    return json.loads(out.strip().splitlines()[-1])
