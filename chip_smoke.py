#!/usr/bin/env python3
"""GPU smoke of nemotron_tpu_torch: builds the CUDA kernels from csrc/,
holds each against its plain PyTorch version, runs the full-width streaming
tick on the card against the CPU at right contexts 0, 1, 6 and 13, serves
TCP clients through the port's own server, transcribes files offline
(the ragged batch encoder, the API and the offline CLI), and drives the
engine's migration, hot swap, events, legacy flow and phase timers,
runs diarization (nets, pipeline, server, CLI) and the native ingest
server, and serves on a dp x tp device mesh and through four replicas —
all on one CUDA card (phase 9 also across two where there are two).

    python3 chip_smoke.py     # every phase; needs one CUDA card

Phases, one line each, any failure exits non-zero:
  1 device   nvidia-smi name / power limit, torch's device name
  2 build    nvcc of nemotron_tpu_torch/csrc/*.cu, one process per file
  3 kernels  each kernel vs its plain version at the main path's shapes
             (max |err|, device ms per call of both, the bound and which
             term binds, library_ms where one PyTorch call computes the
             same function): B1 at B in {32, 256} over dense and int8
             caches in f32 and bf16 (SDPA beside the dense ones), B3 (the
             fused attention block) at B in {32, 256} in f32 and bf16 over
             dense and int8 caches (unfused_ms: the port's sub-block
             without B3, LN + torch.matmul + B1, beside it), B2 (log-mel)
             at B x frames in {256 x 8, 32 x 8, 1 x 8, 1 x 6000} and, for
             right contexts 1 / 6 / 13, {256 x 16, 256 x 56, 256 x 112,
             1 x 112}, over a dense and a slaney filterbank (rfft_ms:
             cuFFT + torch.matmul beside it; each also within 1e-4 of the
             exact float64 log-mel) and, untimed, on a loud tone and on
             silence, B4 (Q8_0) and B5 (Q4_0) in bf16 at M in {32, 141,
             256} and in f32 at M in {256, 141}, both also at M in {512,
             1792, 3584} (a B=256 tick at right context 1 / 6 / 13) and
             at the offline rows M in {769, 6152, 16384} (one and eight
             60 s files, 8 full segments), for the four (N, K) of the
             encoder's matrices (dense_ms: cuBLAS on the weight
             dequantized beforehand, its f32 FFMA product in f32; B5's
             library_ms: torch._weight_int4pack_mm), each with the plan
             ops/quant.py takes (in bf16 the route: the M <= 256 form
             below gemm_plan's crossover, the large-M form from it; the
             rows past 256 timed over 3 repeats, not 5); B2 also at 1 x
             16376 (one offline segment); kv_rows (the slot operations'
             masked row rewrites, no TPU kernel) on one K buffer of the
             B=256 R=0 bf16 state in its three modes (the wrap's shift, a
             realign's roll, the reset's zero) over 1, 16 and 256 masked
             slots, bit for bit, index_ms beside it (the row selection by
             torch.nonzero and indexed copies that it replaced) and, for
             the zero, library_ms: masked_fill_
  4 tick     full-width random model (Hparams() defaults), 4 streams x 10
             fused ticks (through the slack-buffer wrap) on the card vs the
             same ticks on the CPU: f32 and bf16 dense; the same with the
             attention block (B3), and f32 int8 K/V with it; (a) f32 Q8_0
             + int8 K/V, (b) f32 Q4_0, (c) bf16 Q8_0 + int8 K/V; at right
             contexts 1 / 6 / 13 one k = n_phases tick and 9 / 5 / 3
             single ticks: f32 dense at each, (a) and (c) at 13
  5 server   StreamServer on a free localhost port (batch 8), 4 concurrent
             clients x ~3 s of PCM, five times: f32 dense, bf16 Q8_0 +
             int8 K/V (the serving form), bf16 Q4_0, bf16 int8 K/V with
             the attention block, all at right context 0, and the serving
             form with clients at right contexts 13, 13, 6 and 0 (three
             engine groups); the kernel launch counts of each run;
    cli      the streaming CLI in a subprocess on an F16 GGUF of the random
             model against an in-process StreamSession: at right context 0
             with the block (the session without it), and at 13; the
             first again with every tick eager (phase 10's RTF beside the
             graphed one)
  6 offline  full width, the random model's blank bias OFFLINE_BIAS: a
             ragged batch of a 3 s and a 6 s file on the card vs the CPU
             (f32 and f32 Q8_0: encode_batch within F32_ATOL, tokens and
             texts equal; bf16 within 2x its own error); the launch counts
             of transcribe_audios with Q8_0 and Q4_0 matrices through the
             offline graphs' replays (B2 once a call, B4 / B5 264 a
             segment, B1 and B3 never); a 170 s file (two segments)
             beside a 5 s one at CAP_BIAS: transcribe_audios equal to
             transcribe_audio of each, with timestamps, then graphed
             (capture, then replay; both segments on one decode key)
             against eager: texts, token ids and the decoder state bit
             for bit; the offline CLI in a
             subprocess on an F16 GGUF, its stdout equal to the in-process
             texts; graphed against eager in turns at B=1 and B=8 on 60 s
             files in f32, bf16, bf16 Q8_0 and bf16 Q4_0 (bit for bit as
             above; one timed call each way; bf16 Q4_0, whose random
             weights emit, timed by its parity calls alone; host s,
             audio-s/s, device busy and idle
             share, kernels
             per segment, decode iterations, peak memory, each offline
             key's captures, capture s, pool MB and replays; each form's
             offline graphs dropped after its runs)
  7 surface  the engine's remaining surface at full width: two streams of
             a batch-8 engine exported mid-flight at a phase other than 0
             through snapshot_to_bytes / snapshot_from_bytes into an
             engine at another phase, every stream's text equal to an
             unmigrated run (f32, bf16, f32 int8 K/V, f32 Q8_0, bf16 Q4_0
             at R=0; f32 at R=13 after a k = n_phases backlog tick),
             launches B2 once and B4 / B5 264 per chunk step, B1 24 at
             R=0; snapshot bytes per stream; a confidence=True engine's
             events (at_sec never decreasing, conf in (0, 1], texts equal
             to a plain engine's);
             the fast flow, the legacy flow (gated_realign=False) and the
             phase timers on a staggered schedule at batch 8 (equal texts,
             B1 on no legacy gated tick); StreamServer.hot_swap with live
             clients in f32 at batch 64 (to the same weights: texts equal
             to no swap, byte for byte; to other weights: every stream
             ends) and 256 (stall, export and import seconds, snapshot
             bytes); encoder / decoder seconds per tick of a
             phase_timers=True engine at batch 256 in f32 and bf16 with
             each half's device busy share
  8 diarize  the published MarbleNet / TitaNet-L widths (a random diarize
             GGUF written with the port's GGUF writer) and the full-width
             random ASR model in f32 at R=0: VAD over 256 windows and
             TitaNet-L over 64 sub-segments (half of them ragged) card vs
             CPU, their device times and windows/s; NME-SC's host time for
             200 embeddings; both nets through DiarizePipeline graphed
             (one CUDA graph per net and bucket) against eager, bit for
             bit, host ms per call both ways; a fixed 30 s two-speaker
             signal through DiarizePipeline on the card and the CPU
             (segments, RTTM and speaker count equal) and eagerly on the
             card (every embedding bit-equal to the graphed run's);
             StreamServer with the diarize model, 4
             TCP clients x 6 s, two of them diarize streams (word frames and
             a result frame each; every text equal to a plain server's; B1
             24 and B2 >= 1 per chunk step); the streaming CLI with
             --diarize --rttm --json in a subprocess against the in-process
             session and pipeline;
    native   the native ingest server (serving/native_server.py) at batch 8,
             4 clients x 3 s, texts equal to the asyncio server's; then 64
             real-time paced clients x 6 s (in a process of their own) on
             each server: emit p50 / p99, host ms per tick, idle share
  9 mesh     every mesh on cuda:0 (parallel/mesh.py; a one-card machine):
             the kernels at a tp shard's shapes against their plain
             versions, timed beside phase 3's rows (B3 at 4 and 2 heads of
             D=1024 with the residual off, f32 / bf16, dense / int8; B4 /
             B5 at the four tp=2 (N, K), f32 / bf16, M = 256 and 3,584; B2
             at a dp=2 shard's 128 x 8 and 16 x 8; B1 on a head-sharded
             int8 cache); tick parity at B=32 over 6
             ticks, a dp=2 x tp=2 mesh against one device (f32 dense:
             tokens equal, leaves within 1e-4; bf16 with the block, bf16
             Q8_0 + int8 K/V, bf16 Q4_0: PERF.md section 2's rule against
             the f32 run) and dp=2 at R=13 (f32); the asyncio server on
             the 2x2 mesh and the native server on dp=2, 4 clients x 3 s,
             texts equal to one device's; a stream exported from a dp=2
             engine finishing on one device with the text of never moving;
             4 replicas of the port's server behind a RoutedClient, 4
             streams one per replica, texts equal to a session's; a tp
             group's calls as CUDA graphs (each rank on a stream of its
             own): tools/graph_turns.run_schedule at B=32 on the 2x2 mesh
             (every phase through the wrap, the k=4 backlog, a masked tick
             and its realign, a join; warm-up, capture, replay) on an eager
             and a graphed twin in f32 dense (B1) and bf16 Q8_0 int8 K/V
             with dense attention matrices and the block (B3, B4): tokens
             equal, leaves bit-equal (f32 within 1e-6), one capture per key
             and dp shard, the last pass under set_sync_debug_mode
             ("error"), launches through the replays equal to eager's; the
             2x2 offline path on a 6 s file graphed against eager (ids and
             decoder state bit for bit); host ms per graphed B=256 tick
             at dp x tp = 1x1, 2x1, 2x2, busy and idle share, kernels per
             tick, and the tp reduction's device ms (one card: overhead,
             not scaling); where there are two cards, across them: 2x1
             and 1x2 tick parity against one device, the f32 schedule and
             the offline path on 1x2 graphed against eager, and B=256
             ticks at 2x1 and 1x2 eager and graphed
 10 graphs   the compiled tick (graphs.py; every entry point above ran
             graphed, the default): tools/graph_turns.run_schedule at
             B=256 (every phase through the wrap, the k=4 backlog, a
             masked tick with half the slots paused and their realign, a
             join; three passes: warm-up, capture, replay) on an eager and
             a graphed twin of f32, bf16 with the block, bf16 int8 K/V,
             bf16 Q8_0 + int8 K/V and bf16 Q4_0 at R=0 and bf16 int8 K/V
             at R=13: tokens equal, leaves bit-equal (f32 within 1e-6),
             one capture per key (the ticks' and the slot operations'),
             the last pass (uploads, replays, slot operations) under
             set_sync_debug_mode("error"), launches through the replays
             equal to eager's; an engine under churn (tools/graph_turns
             .Churn: B=256 R=0 bf16 int8 K/V, joins, a quarter of the
             streams pausing and resuming at deltas 1-7, wraps with paused
             slots, backlog ticks) eager and graphed in lockstep: texts
             and final leaves equal, each slot operation's key captured
             once, its last 64 ticks' slot operations under
             set_sync_debug_mode("error"); the serving form's server with
             clients at 13, 13, 6, 0 in lockstep, twice each way (texts
             equal in all four runs; each engine group's host
             ms per dispatch, captures, capture seconds, pool bytes); the
             phase timers eager beside phase 7's graphed ones; the CLI's
             RTF both ways (phase 5); then the tick table in turns eager
             and graphed: fused_tick_packed at B=32 and B=256 in f32, and
             at B=256 in bf16 dense, bf16 + int8 K/V, bf16 Q8_0 + int8 K/V,
             bf16 Q4_0, f32 Q8_0 + int8 K/V, and f32, bf16 and bf16 + int8
             K/V with the block, all at right context 0, and in f32 and
             bf16 + int8 K/V at right contexts 6 and 13 (host ms, device
             busy, idle share, real-time streams, kernels per tick; the
             eager rows' kernels and the decode half alone)
The second-to-last line is the kernels JSON (launches: the streaming
server runs, graphed, counted through the replays; offline_launches:
phase 6's counted run, every key replayed; diarize_launches and native_launches: phase 8's
diarize server and native server runs; mesh_launches: phase 9's runs on
the mesh; mesh_cases: phase 9's kernel checks at a tp shard's shapes;
graph_launches: phase 10's graphed schedules), the line before it phase
7's launch counts, the last line the device JSON.
The package is imported from the checkout; nothing of jax or of the JAX
package `nemotron_tpu` is imported.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np

BLANK_BIAS = 2.4  # random weights emit ~2 tokens per 80 ms frame (bench.py)
SEED = 0
N_TICKS = 10      # phase 4: past the slack-buffer wrap at 8
F32_ATOL = 1e-3   # card vs CPU, f32 state leaves
BF16_VS_REF = 2.0  # card vs CPU in bf16, in units of bf16's own error
GEMM_REL = {"f32": 1e-5, "bf16": 1e-2}  # B4/B5 vs plain, x max|y|
RC_MODES = (1, 6, 13)  # right contexts past 0: chunk_len 2, 7, 14
RC_ROWS = (512, 1792, 3584)  # B4/B5 rows of a B=256 tick at those modes
# B4/B5 rows of the offline path: one and eight 60 s files (769 encoder
# frames each), eight full segments (2,048 each)
OFFLINE_ROWS = (769, 6152, 16384)
RC_TICKS = {1: 9, 6: 5, 13: 3}  # phase 4: single ticks, one past a wrap
TICK_BLOCKS = 4  # the timed ticks' blocks of audio, drawn before the loop
# phase 6: the random model's blank bias offline. With full attention over
# a file its decode swings between no token and the 10-symbol cap on every
# frame as the bias moves: at 1.5 the ragged batch's 3 s file emits (its
# 60 s files do not), at 1.0 every frame is at the cap.
OFFLINE_BIAS = 1.5
CAP_BIAS = 1.0     # the long file: every frame emits, the decode's worst
OFFLINE_SECS = 60  # the timed files
# a file past one segment: 16,376 + 624 mel frames (170.0 s)
LONG_SAMPLES = (16376 + 624) * 160 + 96


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, launches: int = 50, repeats: int = 5) -> float:
    """Device ms per call of fn(): CUDA events around `launches` back-to-back
    calls, median over `repeats`. A device-side spin queued first keeps
    the device busy until every call is enqueued, so the events time the
    device work and not the host's launch overhead: it lasts twice the
    host's time to enqueue them (measured on a warm-up call) plus 5 ms. A
    call longer than 0.5 ms (the offline rows) is timed over fewer
    launches, ~25 ms of them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3  # ms to enqueue one call
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    one = start.elapsed_time(end)
    if one > 0.5:
        launches = max(4, min(launches, int(25.0 / one)))
    spin = int(2e6 * (2.0 * host * launches + 5.0))  # ~1 ms per 2M cycles
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def _attn_case(torch, rng, dev, dtype, int8, B):
    """B1 inputs at the main path's shape (B streams, H=8, S_buf=78,
    Dh=128): random validity windows, dead slots at -1e9; int8 caches
    carry garbage codes and scales there."""
    from nemotron_tpu_torch.ops.kvquant import quantize_kv

    H, Dh, S = 8, 128, 78

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            device=dev).to(dtype)

    q, kn, vn = t(B, H, Dh), t(B, H, Dh), t(B, H, Dh)
    kb, vb = t(B, H, S, Dh), t(B, H, S, Dh)
    pm = (rng.standard_normal((B, H, S + 1)) / np.sqrt(Dh)).astype(np.float32)
    lo = rng.integers(0, 9, B)
    valid = rng.integers(1, 71, B)
    dead = []
    for b in range(B):
        live = np.zeros(S + 1, bool)
        live[lo[b] + 70 - valid[b]:lo[b] + 70] = True
        live[S] = True
        pm[b, :, ~live] = -1e9
        dead.append(~live[:S])
    if int8:
        kb, vb = quantize_kv(kb), quantize_kv(vb)
        dead = torch.tensor(np.stack(dead), device=dev)[:, None, :]
        for buf in (kb, vb):
            buf.q.masked_fill_(dead[..., None], 127)
            buf.s.masked_fill_(dead, 3.0e4)
    return q, kn, vn, torch.tensor(pm, device=dev), kb, vb


def _block_case(torch, rng, dev, dtype, int8, B):
    """B3 inputs at full width (D=1024, H=8, Dh=128, S_buf=78): random
    validity windows, dead slots at -1e9 in the mask and 0 in pp; int8
    caches carry garbage codes and scales there."""
    from nemotron_tpu_torch.ops.kvquant import quantize_kv

    H, Dh, S = 8, 128, 78
    D = H * Dh

    def t(*shape, scale=1.0, dt=dtype):
        return torch.tensor((rng.standard_normal(shape) * scale).astype(
            np.float32), device=dev).to(dt)

    live = np.zeros((B, S + 1), bool)
    lo, valid = rng.integers(0, 9, B), rng.integers(1, 71, B)
    for b in range(B):
        live[b, lo[b] + 70 - valid[b]:lo[b] + 70] = True
    live[:, S] = True
    pp = t(H, Dh, S + 1, scale=0.5, dt=torch.float32) * torch.tensor(
        live.any(0), device=dev)
    kb, vb = t(B, H, S, Dh), t(B, H, S, Dh)
    if int8:
        kb, vb = quantize_kv(kb), quantize_kv(vb)
        dead = torch.tensor(~live[:, :S], device=dev)[:, None, :]
        for buf in (kb, vb):
            buf.q.masked_fill_(dead[..., None], 127)
            buf.s.masked_fill_(dead, 3.0e4)
    return dict(
        x=t(B, D), ln_w=1 + t(D, scale=0.1), ln_b=t(D, scale=0.1),
        q_w=t(D, D, scale=D ** -0.5), k_w=t(D, D, scale=D ** -0.5),
        v_w=t(D, D, scale=D ** -0.5), out_w=t(D, D, scale=D ** -0.5),
        bias_u=t(H, Dh, scale=0.1), bias_v=t(H, Dh, scale=0.1), pp=pp,
        mask=torch.tensor(np.where(live, 0.0, -1e9).astype(np.float32),
                          device=dev).to(dtype),
        k_buf=kb, v_buf=vb, n_heads=H, d_head=Dh)


def _unfused_block(torch, a):
    """The port's attention sub-block without B3, as ASRModel(attn_block=
    False) runs it (models/encoder.py, ops/rel_attention.py), on B3's
    inputs: LN, the three projections by torch.matmul, the position term
    from pp, B1, the out projection and the residual. A yardstick for B3
    (`unfused_ms`), not the same kernel."""
    import math

    from nemotron_tpu_torch.ops.attn_kernel import t1_attention_core
    from nemotron_tpu_torch.ops.basic import layer_norm

    x, H, Dh = a["x"], a["n_heads"], a["d_head"]
    B = x.shape[0]

    def run():
        y = layer_norm(x, a["ln_w"], a["ln_b"])
        q, kn, vn = (torch.matmul(y, a[w].T).view(B, H, Dh)
                     for w in ("q_w", "k_w", "v_w"))
        pos = torch.einsum("bhd,hds->bhs", (q + a["bias_v"]).float(), a["pp"])
        pm = pos * (1.0 / math.sqrt(Dh)) + a["mask"].float()[:, None, :]
        ctx = t1_attention_core(q + a["bias_u"], kn, vn, pm, a["k_buf"],
                                a["v_buf"])
        return x + torch.matmul(ctx.reshape(B, H * Dh), a["out_w"].T), kn, vn
    return run


HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak rate
PEAK_OPS = {"f32": 67e12, "bf16": 989e12}  # f32 CUDA cores; bf16 tensor cores


def tensor_bytes(*ts) -> int:
    """Bytes of tensors (an int8 cache counted as its codes and scales)."""
    from nemotron_tpu_torch.ops.kvquant import is_quant

    total = 0
    for t in ts:
        parts = (t.q, t.s) if is_quant(t) else (t,)
        total += sum(x.numel() * x.element_size() for x in parts)
    return total


def bound(nbytes: int, ops: float, dname: str) -> tuple[float, str]:
    """The least ms the card could take: bytes over HBM's rate or operations
    over the type's peak, the larger, and which of the two binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dname] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _int4pack_mm(torch, qt, n, k):
    """torch._weight_int4pack_mm over a Q4_0 weight: group size 32, bf16
    scales, zero points 0, so it computes (q - 8) * s as B5 does (with
    bf16 scales); None where this PyTorch build does not run it."""
    try:
        w32 = qt.w_packed.to(torch.int32)
        q = torch.cat([w32 & 15, w32 >> 4], dim=-1)  # [N, K], 0..15
        packed = ((q[:, ::2] << 4) | q[:, 1::2]).to(torch.uint8)
        wp = torch._convert_weight_to_int4pack(packed, 8)
        sz = torch.stack([qt.scales.T, torch.zeros_like(qt.scales.T)],
                         dim=-1).to(torch.bfloat16).contiguous()
        fn = lambda x: torch._weight_int4pack_mm(x, wp, 32, sz)  # noqa: E731
        fn(torch.zeros((1, k), dtype=torch.bfloat16, device=qt.scales.device))
        torch.cuda.synchronize()
        return fn
    except Exception as e:  # noqa: BLE001 - reported, and timed as null
        log(f"[3 kernels] torch._weight_int4pack_mm does not run here: "
            f"{type(e).__name__}: {str(e)[:160]}")
        return None


def _kv_index_path(torch, buf, mode, mask, lo=0, lc=0, shift=0):
    """kv_rows' function by the row selection the port used before it:
    torch.nonzero of the mask (a host sync), then indexed copies of the
    selected slots (index_ms, a yardstick)."""
    rows = torch.nonzero(mask).flatten()
    if mode == 0:
        sel = buf[:, rows]
        sel[:, :, :, :lc] = sel[:, :, :, lo:lo + lc].clone()
        buf[:, rows] = sel
    elif mode == 1:
        buf[:, rows] = torch.roll(buf[:, rows], shift, dims=3)
    else:
        buf[:, rows] = 0


def phase_kernels(torch, report):
    """Each kernel against its plain version at the main path's shapes, with
    its bound and, where one PyTorch call computes the same function, that
    call's time (library_ms); B4/B5 also beside cuBLAS's dense product of
    the weight dequantized beforehand (dense_ms, not the same function)."""
    from nemotron_tpu_torch import kernels
    from nemotron_tpu_torch.ops import kv_rows, quant
    from nemotron_tpu_torch.ops.attn_block import (attn_group,
                                                   block_f32_plans,
                                                   block_gemm_plans,
                                                   t1_attention_block,
                                                   t1_attention_block_ref)
    from nemotron_tpu_torch.ops.attn_kernel import (attn_plan, sm_count,
                                                    t1_attention_core,
                                                    t1_attention_core_ref)
    from nemotron_tpu_torch.ops.mel_kernel import (filterbank_layout,
                                                   mel_frames, mel_frames_ref,
                                                   mel_plan, wide_bands)
    from nemotron_tpu_torch.tools.gemm_turns import (mel_cases, mel_exact,
                                                     rfft_mel)

    F = torch.nn.functional
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    ok = True

    def check(kname, case, got, want, tol, fn, plain, nbytes, ops, dname,
              library=None, repeats=5, **extra_fns):
        nonlocal ok
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        good = bool(torch.isfinite(got).all()) and err <= tol
        ok &= good
        b_ms, b_by = bound(nbytes, ops, dname)
        res = dict(max_abs_err=err, ms=cuda_ms(fn, repeats=repeats),
                   plain_ms=cuda_ms(plain, repeats=repeats),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=None if library is None else cuda_ms(
                       library, repeats=repeats))
        res.update({k: cuda_ms(f, repeats=repeats)
                    for k, f in extra_fns.items()})
        log(f"[3 kernels] {kname} {case}: max|err| {err:.3e} (bound "
            f"{tol:.3g}) {'ok' if good else 'FAIL'}; kernel {res['ms']:.4f} "
            f"ms, plain {res['plain_ms']:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by}, share {b_ms / res['ms']:.2f})"
            + "".join(f", {k} {v:.4f} ms" for k, v in res.items()
                      if k.endswith("_ms") and k not in
                      ("ms", "plain_ms", "bound_ms") and v is not None))
        report[kname].setdefault("cases", {})[case] = res
        return res

    sms = sm_count(dev)
    for B, int8, (dtype, atol) in itertools.product(
            (32, 256), (False, True),
            ((torch.float32, 2e-5), (torch.bfloat16, 2e-2))):
        args = _attn_case(torch, rng, dev, dtype, int8, B)
        dname = "f32" if dtype == torch.float32 else "bf16"
        q, kn, vn, pm, kb, vb = args
        H, Dh = q.shape[1:]
        S = pm.shape[-1] - 1
        plan = attn_plan(B * H, S, sms)
        log(f"[3 kernels] t1_attention {dname} "
            f"{'int8' if int8 else 'dense'} B={B}: plan {plan}")
        library = None
        if not int8:  # SDPA over [K_buf; k_new], pos_mask additive
            kc = torch.cat([kb, kn[:, :, None]], dim=2)
            vc = torch.cat([vb, vn[:, :, None]], dim=2)
            mc = pm[:, :, None, :].to(dtype)

            def library(q=q, kc=kc, vc=vc, mc=mc):
                return F.scaled_dot_product_attention(
                    q[:, :, None], kc, vc, attn_mask=mc)[:, :, 0]
            lib_err = float((library().float()
                             - t1_attention_core_ref(*args).float()
                             ).abs().max())
            log(f"[3 kernels] t1_attention {dname} dense B={B}: SDPA "
                f"max|diff| to the plain version {lib_err:.3e}")
        res = check(
            "t1_attention", f"{'int8' if int8 else 'dense'} caches, "
            f"{dname} B={B} H=8 S_buf=78 Dh=128",
            t1_attention_core(*args), t1_attention_core_ref(*args), atol,
            lambda: t1_attention_core(*args),
            lambda: t1_attention_core_ref(*args),
            tensor_bytes(*args) + tensor_bytes(q),
            4.0 * B * H * (S + 1) * Dh, dname, library)
        if (B, int8, dname) == (256, False, "bf16"):  # SDPA beside it
            report["t1_attention"].update(res)

    def flat(outs):  # (out, k_new, v_new) as one vector
        return torch.cat([o.float().flatten() for o in outs])

    for b in (32, 256):
        for int8 in (False, True):
            for dname, dtype in (("f32", torch.float32),
                                 ("bf16", torch.bfloat16)):
                a = _block_case(torch, rng, dev, dtype, int8, b)
                want = t1_attention_block_ref(**a)
                H, Dh = a["n_heads"], a["d_head"]
                D, S = H * Dh, a["mask"].shape[-1] - 1
                ins = [v for v in a.values() if not isinstance(v, int)]
                elem = 1 if int8 else dtype.itemsize
                plans = (block_gemm_plans(b, D, sms) if dname == "bf16" else
                         block_f32_plans(b, D, S, Dh, elem, sms))
                splits = plans[0].splits
                log(f"[3 kernels] t1_attention_block {dname} "
                    f"{'int8' if int8 else 'dense'} B={b}: projections "
                    f"{plans}, attention "
                    f"{attn_group(b, H, S, Dh, elem, splits, sms)}")
                unfused = _unfused_block(torch, a)
                u_err = float((flat(unfused()) - flat(want)).abs().max())
                log(f"[3 kernels] t1_attention_block {dname} B={b}: the "
                    f"unfused sub-block's max|diff| to the plain version "
                    f"{u_err:.3e}")
                res = check(
                    "t1_attention_block",
                    f"{'int8' if int8 else 'dense'} caches, {dname} B={b} "
                    f"D=1024 H=8 S_buf=78 Dh=128",
                    flat(t1_attention_block(**a)), flat(want),
                    GEMM_REL[dname] * float(flat(want).abs().max()),
                    lambda: t1_attention_block(**a),
                    lambda: t1_attention_block_ref(**a),
                    tensor_bytes(*ins, *want),
                    2.0 * b * D * 4 * D + 6.0 * b * H * (S + 1) * Dh, dname,
                    unfused_ms=unfused)
                if (b, int8, dname) == (256, True, "bf16"):  # serving form
                    report["t1_attention_block"].update(res)

    for bits, kname in ((8, "q8_matmul"), (4, "q4_matmul")):
        qz = quant.quantize_q8 if bits == 8 else quant.quantize_q4
        fn, ref, deq = ((quant.linear_q8, quant.linear_q8_ref,
                         quant.dequantize) if bits == 8 else
                        (quant.linear_q4, quant.linear_q4_ref,
                         quant.dequantize_q4))
        for n, k in ((4096, 1024), (1024, 4096), (2048, 1024), (1024, 1024)):
            qt = qz((rng.standard_normal((n, k)) / np.sqrt(k)).astype(
                np.float32)).to(dev)
            codes = qt.w_i8 if bits == 8 else qt.w_packed
            lib = _int4pack_mm(torch, qt, n, k) if bits == 4 else None
            for dname, dtype, batches in (
                    ("bf16", torch.bfloat16,
                     (32, 141, 256) + RC_ROWS + OFFLINE_ROWS),
                    ("f32", torch.float32,
                     (256, 141) + RC_ROWS + OFFLINE_ROWS)):
                w_dense = deq(qt, dtype)  # cuBLAS's operand, made once
                for m in batches:
                    x = torch.tensor(rng.standard_normal((m, k)).astype(
                        np.float32), device=dev).to(dtype)
                    want = ref(x, qt)
                    library = None
                    if lib is not None and dtype == torch.bfloat16:
                        library = lambda x=x: lib(x)  # noqa: E731
                        log(f"[3 kernels] {kname} bf16 M={m} N={n} K={k}: "
                            f"_weight_int4pack_mm max|diff| to the plain "
                            f"version {float((lib(x).float() - want.float()).abs().max()):.3e} "
                            f"(max|y| {float(want.float().abs().max()):.3g})")
                    plan = (quant.gemm_plan(m, n, k, bits, sms)
                            if dname == "bf16" else
                            quant.f32_plan(m, n, k, sms))
                    log(f"[3 kernels] {kname} {dname} M={m} N={n} K={k}: "
                        f"plan {plan}")
                    # the rows of many streams: 3 repeats, not 5
                    res = check(
                        kname, f"{dname} M={m} N={n} K={k}", fn(x, qt), want,
                        GEMM_REL[dname] * float(want.abs().max()),
                        lambda x=x: fn(x, qt), lambda x=x: ref(x, qt),
                        tensor_bytes(codes, qt.scales, x, want),
                        2.0 * m * n * k, dname, library,
                        repeats=5 if m <= 256 else 3,
                        dense_ms=lambda x=x, w=w_dense: torch.matmul(x, w.T))
                    if (m, n, k, dname) == (256, 4096, 1024, "bf16"):
                        report[kname].update(res)

    # B2 at the shapes its paths run: B x frames in {256 x 8, 32 x 8, 1 x 8,
    # 1 x 6000} and, for the ticks at right context 1 / 6 / 13, {256 x 16,
    # 256 x 56, 256 x 112, 1 x 112}, and one offline segment, 1 x 16,376,
    # dense and slaney filterbanks; each
    # also within 1e-4 of the exact float64 log-mel; bound: the least work of
    # the function, not of the kernel: per frame the window,
    # a 512-point FFT (2.5 N log2 N), the power, the filterbank's non-zero
    # terms and the log; the bytes of the audio, the window, the
    # filterbank's non-zeros and the output. rfft_ms: cuFFT + torch.matmul
    fbs = {}
    for case, b, f, buf, win, fb in mel_cases(torch, dev, rng):
        fbs[case.rsplit(" ", 1)[1]] = fb
        want = mel_frames_ref(buf, win, fb, f)
        n_mels, nnz = fb.shape[0], int((fb != 0).sum())
        frame_ops = 512 + 2.5 * 512 * 9 + 3.0 * 257 + 2.0 * nnz + n_mels
        got = mel_frames(buf, win, fb, f)
        exact = mel_exact(torch, buf, win, fb, f)
        plan = mel_plan(b, f, wide_bands(filterbank_layout(fb)), sms)
        r_err = float((rfft_mel(torch, buf, win, fb, f) - exact).abs().max())
        x_err = float((got - exact).abs().max())
        ok &= x_err <= 1e-4
        log(f"[3 kernels] mel_frames {case}: plan {plan} "
            f"frames per block; max|diff| to the exact float64 log-mel: "
            f"kernel {x_err:.3e} (bound 1e-4) "
            f"{'ok' if x_err <= 1e-4 else 'FAIL'}, plain "
            f"{float((want - exact).abs().max()):.3e}, rfft yardstick "
            f"{r_err:.3e}")
        res = check(
            "mel_frames", f"{case} mels={n_mels}", got,
            want, 1e-3, lambda: mel_frames(buf, win, fb, f),
            lambda: mel_frames_ref(buf, win, fb, f),
            tensor_bytes(buf, win, want) + 4 * nnz, b * f * frame_ops, "f32",
            rfft_ms=lambda: rfft_mel(torch, buf, win, fb, f))
        if case == "B=256 x 8 dense":  # the tick's headline
            report["mel_frames"].update(res)
    # untimed: a full-scale 300 Hz tone with noise at -60 dB (loud bins
    # beside bands just above the guard) and digital silence, where both
    # versions give log(2^-24) exactly; held to the exact float64 log-mel
    # at 1e-4, and to the plain version at 1e-3 except on the tone through
    # the slaney filterbank, where the plain version's f32 DFT-matmul is
    # itself farther than that from the exact value (both printed)
    t = np.arange(1632) / 16000.0
    tone = torch.tensor((np.sin(2 * np.pi * 300.0 * t) + 1e-3
                         * rng.standard_normal((32, 1632))).astype(np.float32),
                        device=dev)
    floor = float(np.log(np.float32(2.0 ** -24)))
    for name, x in (("tone", tone), ("silence", torch.zeros_like(tone))):
        for kind, fb in fbs.items():
            got = mel_frames(x, win, fb, 8)
            want = mel_frames_ref(x, win, fb, 8)
            exact = mel_exact(torch, x, win, fb, 8)
            err = float((got - exact).abs().max())
            to_plain = float((got - want).abs().max())
            good = bool(torch.isfinite(got).all()) and err <= 1e-4
            if (name, kind) != ("tone", "slaney"):
                good &= to_plain <= 1e-3
            if name == "silence":
                good &= bool((got == floor).all() and (want == floor).all())
            ok &= good
            log(f"[3 kernels] mel_frames {name} B=32 x 8 {kind}: max|diff| "
                f"to the exact log-mel: kernel {err:.3e} (bound 1e-4"
                f"{'; log(2^-24) exactly' if name == 'silence' else ''}) "
                f"{'ok' if good else 'FAIL'}, plain "
                f"{float((want - exact).abs().max()):.3e}; kernel to plain "
                f"{to_plain:.3e}")
    # kv_rows on one K buffer of the full-width state at B=256, R=0, bf16
    # ([24, 256, 8, 78, 128]): the wrap's shift (lo 8, lc 70), a realign's
    # roll (delta +1) and the reset's zero over 1, 16 and 256 masked
    # slots, exact; bound: the masked rows' bytes (shift 2 lc W, roll 2 S W,
    # zero S W a row, W = Dh x 2 bytes a frame)
    buf = torch.randn((24, 256, 8, 78, 128), device=dev).to(torch.bfloat16)
    row = 78 * 128 * 2
    for n_set in (1, 16, 256):
        m = torch.zeros(256, dtype=torch.bool, device=dev)
        m[torch.randperm(256, device=dev)[:n_set]] = True
        for mode, kw, moved in ((kv_rows.SHIFT, dict(lo=8, lc=70),
                                 2 * 70 * 128 * 2),
                                (kv_rows.ROLL, dict(shift=1), 2 * row),
                                (kv_rows.ZERO, {}, row)):
            got = kv_rows.kv_rows_(buf.clone(), mode, m, **kw)
            want = kv_rows.kv_rows_ref_(buf.clone(), mode, m, **kw)
            work, plain, idx = buf.clone(), buf.clone(), buf.clone()
            m5 = m.reshape(1, -1, 1, 1, 1)
            lib = (None if mode != kv_rows.ZERO else
                   lambda w=work, m5=m5: w.masked_fill_(m5, 0))
            res = check(
                "kv_rows", f"{kv_rows.MODES[mode]} bf16 [24, 256, 8, 78, "
                f"128], {n_set} of 256 slots", got, want, 0.0,
                lambda w=work, mode=mode, kw=kw, m=m: kv_rows.kv_rows_(
                    w, mode, m, **kw),
                lambda w=plain, mode=mode, kw=kw, m=m: kv_rows.kv_rows_ref_(
                    w, mode, m, **kw),
                24 * n_set * 8 * moved + 256, 0.0, "bf16", lib,
                index_ms=lambda w=idx, mode=mode, kw=kw, m=m: _kv_index_path(
                    torch, w, mode, m, **kw))
            if (n_set, mode) == (256, kv_rows.SHIFT):  # the wrap
                report["kv_rows"].update(res)
            del got, want, work, plain, idx
    del buf
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("phase 3: a kernel disagrees with its plain version")
    kernels.reset_counts()


def stream_audio(n_streams: int, n_samples: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 16000.0
    out = np.empty((n_streams, n_samples), np.int16)
    for i in range(n_streams):
        sig = (0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t)
               + 0.1 * rng.standard_normal(n_samples))
        out[i] = (np.clip(sig, -1, 1) * 32767).astype(np.int16)
    return out


def tick_chunks(mode: int, n_ticks: int) -> list[int]:
    """The chunks of each tick of a phase-4 run: at right context 0,
    n_ticks single ticks; past it, one k = n_phases tick (its wrap inside)
    and then n_ticks single ticks."""
    from nemotron_tpu_torch.config import CacheConfig

    return ([CacheConfig.for_mode(mode).n_phases] if mode else []) \
        + [1] * n_ticks


def run_ticks(model, audio: np.ndarray, n_ticks: int, mode: int = 0):
    """All-active fused ticks (tick_chunks) at right context `mode` over
    `audio` [B, >= 96 + chunks x shift_samples], with the engine's stream
    priming and wrap compaction."""
    from nemotron_tpu_torch.streaming.engine import PRIME_SAMPLES, prime_carry

    cfg = model.cache_config(mode)
    b, shift = audio.shape[0], cfg.shift_samples
    state = model.init_stream_state(b, cfg)
    tails, lasts = zip(*(prime_carry(a[:PRIME_SAMPLES]) for a in audio))
    state = model.prime_frontend(state, np.ones(b, bool), np.stack(tails),
                                 np.asarray(lasts, np.float32), cfg=cfg)
    toks, phase, off = [], 0, PRIME_SAMPLES
    for k in tick_chunks(mode, n_ticks):
        packed = model.pack_tick_inputs(
            audio[:, off:off + k * shift], np.full(b, cfg.valid_out_len),
            np.zeros(b), None)
        off += k * shift
        state, tokens = model.fused_tick_packed(
            cfg, state, model.put_batch(packed), True, phase=phase, k=k)
        toks.append(tokens.cpu().numpy())
        phase = (phase + k) % cfg.n_phases
        if k == 1 and phase == 0:
            state = model.compact_state(cfg, state)
    return state, np.concatenate(toks, axis=1)


def tick_audio(mode: int, n_ticks: int) -> np.ndarray:
    """Phase 4's audio of 4 streams at right context `mode`."""
    from nemotron_tpu_torch.config import CacheConfig

    n = 96 + sum(tick_chunks(mode, n_ticks)) \
        * CacheConfig.for_mode(mode).shift_samples
    return stream_audio(4, n, SEED + 1)


def as_f32(buf):
    """A cache leaf as f32 values (an int8 cache dequantized), on the CPU."""
    from nemotron_tpu_torch.ops.kvquant import dequantize_kv, is_quant

    return (dequantize_kv(buf) if is_quant(buf) else buf.float()).cpu()


def phase_tick(torch, cpu_model, gpu_model, name: str, ref=None, own=None,
               mode: int = 0, n_ticks: int = N_TICKS):
    """The ticks of tick_chunks(mode, n_ticks) over 4 streams on the card
    and on the CPU from the same state.

    f32 (`ref` None): dense K/V, conv cache and decoder state within
    F32_ATOL; the integer leaves and the tokens equal. Int8 K/V: codes
    within +-1 (a value on a rounding boundary may round either way; the
    share of such flips is printed), and, since a flipped code feeds back
    through every later attention read, the dequantized K/V and the conv
    cache are held to int8's own error instead of F32_ATOL: max|card - cpu|
    <= BF16_VS_REF x max|cpu - `own`|, `own` being the CPU run of the same
    weights with dense K/V. The scales' relative error is printed. Past
    right context 0 the random model emits ~10 tokens per frame (~3,300
    argmaxes at R=13 against 40 at R=0), so a flipped code also reaches
    tokens: there the token cells that differ between card and CPU are
    held to int8's own count, <= BF16_VS_REF x the cells that differ
    between the CPU's int8 run and `own`; at R=0 the tokens are equal.
    Returns the CPU's (state, tokens) as the reference for bf16.
    bf16 (`ref` = the f32 CPU run of the same weights and caches): the two
    devices round bf16 at different points, and the 24 layers carry the
    differences on, so the bound is relative to bf16's own error: for each
    token-independent cache (int8 ones dequantized), max|card - cpu| <=
    BF16_VS_REF x max|cpu - f32|. Tokens are reported as their agreement
    with the f32 run (random weights have near-tie argmaxes that bf16
    rounding flips)."""
    from nemotron_tpu_torch.ops.kvquant import is_quant

    b = 4
    audio = tick_audio(mode, n_ticks)
    t0 = time.perf_counter()
    s_gpu, tok_gpu = run_ticks(gpu_model, audio, n_ticks, mode)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_cpu, tok_cpu = run_ticks(cpu_model, audio, n_ticks, mode)
    t_cpu = time.perf_counter() - t0
    hp = gpu_model.hp
    chunks = tick_chunks(mode, n_ticks)
    head = (f"[4 tick] {name} R={mode} B={b} x {len(chunks)} ticks "
            f"({sum(chunks)} chunks of {chunks}; d_model {hp.d_model}, "
            f"{hp.n_layers} layers): ")
    tail = f"; card {t_gpu:.2f} s incl. first use, cpu {t_cpu:.2f} s"

    def err(a, c):
        return float((as_f32(a) - as_f32(c)).abs().max())

    bad = []
    if ref is None:
        errs, flips = {}, {}
        leaves = {n: (getattr(s_gpu, n), getattr(s_cpu, n))
                  for n in ("k_cache", "v_cache", "conv_cache")}
        leaves.update({"decode." + n: (getattr(s_gpu.decode, n),
                                       getattr(s_cpu.decode, n))
                       for n in ("h", "c")})
        own_errs = {}
        for n, (g, c) in leaves.items():
            errs[n] = err(g, c)
            if not bool(torch.isfinite(as_f32(g)).all()):
                bad.append(f"{n} not finite")
            if is_quant(c):
                dq = (g.q.cpu().int() - c.q.int()).abs()
                errs[n + ".q"] = float(dq.max())
                flips[n] = float((dq > 0).float().mean())
                errs[n + ".s rel"] = float(
                    ((g.s.cpu() - c.s).abs() / c.s.abs().clamp_min(1e-30)
                     ).max())
                if errs[n + ".q"] > 1:
                    bad.append(f"{n} codes differ by {errs[n + '.q']:g}")
            if own is not None and n in ("k_cache", "v_cache", "conv_cache"):
                own_errs[n] = err(c, getattr(own[0], n))
                if not errs[n] <= BF16_VS_REF * own_errs[n]:
                    bad.append(f"{n} {errs[n]:.3e} > {BF16_VS_REF:g} x "
                               f"{own_errs[n]:.3e}")
            elif not errs[n] <= F32_ATOL:
                bad.append(f"{n} {errs[n]:.3e}")
        same = torch.equal(s_gpu.cache_valid.cpu(), s_cpu.cache_valid) and \
            all(torch.equal(getattr(s_gpu.decode, n).cpu(),
                            getattr(s_cpu.decode, n))
                for n in ("prev_token", "frame_offset"))
        if not same:
            bad.append("integer leaves differ")
        n_diff = int((tok_gpu != tok_cpu).sum())
        tok_rule = "equal"
        if own is not None and mode:
            n_own = int((tok_cpu != own[1]).sum())
            tok_rule = (f"<= {BF16_VS_REF:g} x int8's own {n_own} (cpu vs "
                        f"dense K/V)")
            if n_diff > BF16_VS_REF * n_own:
                bad.append(f"{n_diff} token cells differ, > {tok_rule}")
        elif n_diff:
            bad.append("tokens differ")
        log(head + f"max|gpu-cpu| {fmt(errs)} (atol {F32_ATOL:g}"
            + (f"; int8 codes 1; K/V and conv <= {BF16_VS_REF:g} x int8's "
               f"own error max|cpu - dense K/V| {fmt(own_errs)}; share of "
               f"int8 codes off by one {fmt(flips)}" if flips else "") + ")"
            + f"; token cells differing {n_diff} of {tok_cpu.size} (want "
            f"{tok_rule}; {int((tok_gpu >= 0).sum())} emitted on the card)"
            + tail)
    else:
        s_ref, tok_ref = ref
        errs, ref_errs = {}, {}
        for n in ("k_cache", "v_cache", "conv_cache"):
            g, c, r = getattr(s_gpu, n), getattr(s_cpu, n), getattr(s_ref, n)
            errs[n], ref_errs[n] = err(g, c), err(c, r)
            if not (bool(torch.isfinite(as_f32(g)).all())
                    and errs[n] <= BF16_VS_REF * ref_errs[n]):
                bad.append(f"{n} {errs[n]:.3e} > {BF16_VS_REF:g} x "
                           f"{ref_errs[n]:.3e}")
        if not torch.equal(s_gpu.cache_valid.cpu(), s_cpu.cache_valid):
            bad.append("cache_valid differs")
        log(head + f"max|gpu-cpu| {fmt(errs)}, max|cpu-f32| {fmt(ref_errs)} "
            f"(bound {BF16_VS_REF:g}x); token cells equal to the f32 run: "
            f"card {float((tok_gpu == tok_ref).mean()):.3f}, cpu "
            f"{float((tok_cpu == tok_ref).mean()):.3f}" + tail)
    if bad:
        raise SystemExit(f"phase 4 ({name}): card and CPU disagree: {bad}")
    return s_cpu, tok_cpu


def fmt(errs: dict) -> str:
    return json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})


async def _serve_clients(model, audios, batch, modes, lockstep=False):
    """Clients i = 0.. streaming audios[i] at right context modes[i]
    through the port's asyncio server: (texts, engine stats). With
    lockstep the engine ticks only once every client has pushed all of
    its audio and ended its stream. The ticks' schedule (joins, k-chunk
    backlogs, masks) then follows from the audio alone, and two servers
    given the same audio must give the same texts: a live run's schedule
    follows the clients' timing, and a stream's rounding follows its
    schedule (the ring phase it joins at, the chunks a tick takes), so in
    bf16 its tokens may differ at a near-tie from one live run to the
    next, on the same model."""
    import threading

    from nemotron_tpu_torch.serving import protocol as P
    from nemotron_tpu_torch.serving.client import transcribe_file
    from nemotron_tpu_torch.serving.server import StreamServer

    srv = StreamServer(model, batch_per_group=batch)
    if lockstep:
        gate, ended = threading.Event(), set()
        dispatch, step = srv._dispatch, srv._engine_step

        async def gated_dispatch(writer, opcode, stream_id, payload):
            await dispatch(writer, opcode, stream_id, payload)
            if opcode == P.OP_STREAM_END:
                ended.add(stream_id)
                if len(ended) == len(audios):
                    gate.set()

        def gated_step(engine):
            while not gate.wait(0.05):
                if srv._stop:
                    return ([], {}, [], {}), False
            return step(engine)

        srv._dispatch, srv._engine_step = gated_dispatch, gated_step
    server = await srv.start("127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    try:
        texts = await asyncio.wait_for(asyncio.gather(*[
            transcribe_file(a, host="127.0.0.1", port=port, chunk_ms=200,
                            right_context=rc)
            for a, rc in zip(audios, modes)]), timeout=300)
    finally:
        await srv.stop(server)
    return texts, srv.engine.stats()


class TickLoop:
    """All-active fused ticks at right context `mode` on a fresh batch-b
    state, one per call, with the engine's phase advance and wrap
    compaction. Each call packs and uploads its block of audio (drawn
    before the loop, TICK_BLOCKS blocks in turn), as the engine does."""

    def __init__(self, model, b: int, mode: int = 0):
        self.model, self.b = model, b
        self.cfg = model.cache_config(mode)
        self.state = model.init_stream_state(b, self.cfg)
        rng = np.random.default_rng(SEED + b)
        self.audio = (rng.standard_normal(
            (TICK_BLOCKS, b, self.cfg.shift_samples)) * 3000).astype(np.int16)
        self.phase = 0
        self.n = 0

    def __call__(self):
        cfg, b = self.cfg, self.b
        audio = self.audio[self.n % TICK_BLOCKS]
        self.n += 1
        packed = self.model.put_batch(self.model.pack_tick_inputs(
            audio, np.full(b, cfg.valid_out_len), np.zeros(b), None))
        self.state, _ = self.model.fused_tick_packed(
            cfg, self.state, packed, True, phase=self.phase)
        self.phase += 1
        if self.phase == cfg.n_phases:
            self.state = self.model.compact_state(cfg, self.state)
            self.phase = 0


def graph_warmup(model, cfg) -> int:
    """Ticks of a TickLoop before every key of a graphed model replays:
    each phase's key is warmed up, then captured (graphs.py)."""
    return 2 * cfg.n_phases if model.graphs.enabled else 0


def profile_rows(torch, fn, n: int = 8, warmup: int = 4):
    """Device kernel time per call of fn() by kernel name (torch.profiler,
    CUPTI, CUDA activity only, summed from the raw trace: an offline call
    issues tens of thousands of kernels, too many for key_averages):
    returns (total device ms per call, [(name, ms per call, calls per
    call)] sorted by time, {device index: ms per call in which some
    kernel ran there}), or None if the trace holds no device time. The
    total counts kernels that overlap on streams of one card (a tp
    group's ranks) once each; the third item counts that time once."""
    from torch.profiler import ProfilerActivity, profile

    from nemotron_tpu_torch.tools.turns import device_ns, union_ms

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((k, ns / 1e6 / n, calls / n)
                   for k, (ns, calls) in device_ns(prof).items()),
                  key=lambda r: -r[1])
    union = {d: ms / n for d, ms in union_ms(prof).items()}
    return (sum(r[1] for r in rows), rows, union) if rows else None


def profile_decode(torch, model, b: int, n: int = 8, mode: int = 0):
    """profile_rows of the tick's decode half alone (models/asr.decode_tick:
    the loop-labels greedy RNNT over chunk_len encoder frames, its fixed
    chunk_len x 11 + 1 iterations) on random encoder frames."""
    from nemotron_tpu_torch.models import asr

    cfg = model.cache_config(mode)
    hp = model.hp
    state = model.init_stream_state(b, cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    enc = torch.randn((b, cfg.chunk_len(hp), hp.d_model), device="cuda",
                      generator=gen).to(model.params.pos_emb.dtype)
    n_valid = torch.full((b,), cfg.valid_out_len, dtype=torch.int32,
                         device="cuda")

    def step():
        asr.decode_tick(model.params, state, enc, n_valid, hp=hp)
    out = profile_rows(torch, step, n)
    del state
    torch.cuda.empty_cache()
    return out


def phase_server(torch, model, name: str, per_step: dict,
                 modes=(0, 0, 0, 0)) -> dict:
    """Four TCP clients through the port's server, client i at right
    context modes[i] (one engine group per mode); the kernel launch counts
    of that run. per_step: kernel -> launches per chunk step that the run
    must show exactly, an int for every mode or {mode: int} (B2,
    mel_frames, at least one per chunk step). With more than one mode,
    every transcript must be non-empty, else at least one."""
    from nemotron_tpu_torch import kernels

    audios = list(stream_audio(4, 48000, SEED + 2))
    kernels.reset_counts()
    texts, stats = asyncio.run(_serve_clients(model, audios, 8, modes))
    counts = {k.name: k.launches for k in kernels.KERNELS}
    steps = {rc: stats["groups"][rc]["chunk_steps"] for rc in set(modes)}
    total = sum(steps.values())
    log(f"[5 server] {name}: 4 clients x 3.0 s at right contexts "
        f"{list(modes)}, batch 8: every stream got OP_ENDED; transcript "
        f"chars {[len(t) for t in texts]}; launches {counts} over chunk "
        f"steps {steps}")
    log(f"[5 server] {name} stats {json.dumps(stats)}")
    if not (all(texts) if len(steps) > 1 else any(texts)):
        raise SystemExit(f"phase 5 ({name}): empty transcripts "
                         f"{[len(t) for t in texts]}")
    want = {k: sum((n if isinstance(n, int) else n[rc]) * st
                   for rc, st in steps.items())
            for k, n in per_step.items()}
    if not all(steps.values()) or counts["mel_frames"] < total or any(
            counts[k] != n for k, n in want.items()):
        raise SystemExit(f"phase 5 ({name}): kernel launches {counts} over "
                         f"chunk steps {steps}, want {want} and mel_frames "
                         f">= {total}")
    return counts


# Runs a CLI module (argv[1], e.g. transcribe_stream) as `python -m` would,
# and prints the kernels' launch counts of that process on stderr when it
# exits. A first argument --eager builds every ASRModel of the run with
# graphs=False (the eager ticks beside the graphed default).
CLI_RUNNER = """
import atexit, json, runpy, sys
from nemotron_tpu_torch import api, kernels
atexit.register(lambda: print("KERNEL_LAUNCHES " + json.dumps(
    {k.name: k.launches for k in kernels.KERNELS}), file=sys.stderr))
sys.argv = sys.argv[1:]
if sys.argv[0] == "--eager":
    sys.argv = sys.argv[1:]
    init = api.ASRModel.__init__
    api.ASRModel.__init__ = lambda self, *a, **kw: init(
        self, *a, **{**kw, "graphs": False})
runpy.run_module("nemotron_tpu_torch.cli." + sys.argv[0],
                 run_name="__main__", alter_sys=True)
"""


def phase_cli(torch, hp, dense, vocab):
    """The streaming CLI on the card: the full-width random model written as
    an F16 GGUF (into the git-ignored _smoke/, deleted afterwards), 3 s of
    PCM through `python -m nemotron_tpu_torch.cli.transcribe_stream` in a
    subprocess, three times: at right context 0 with
    NEMOTRON_TPU_PALLAS_ATTN_BLOCK=1, at right context 13, and (phase 10)
    the first again with every tick eager (CLI_RUNNER --eager) beside the
    graphed default. Each run's stdout must equal the text of an
    in-process StreamSession (graphed) of the same GGUF at the same right
    context without the block, its stderr show the RTF line; the block
    runs launch B3 24 times per chunk and B1 never, the R=13 run neither
    (its attention is T=14). Returns {eager: RTF line} of the two R=0
    runs."""
    import os
    import shutil
    from pathlib import Path

    from nemotron_tpu_torch import kernels
    from nemotron_tpu_torch.api import ASRModel
    from nemotron_tpu_torch.params import save_gguf
    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.streaming.session import StreamSession

    root = Path(__file__).resolve().parent
    work = root / "_smoke"
    work.mkdir(exist_ok=True)
    L = hp.n_layers
    runs = []
    try:
        gguf, pcm = work / "random_f16.gguf", work / "audio.pcm"
        t0 = time.perf_counter()
        save_gguf(str(gguf), hp, dense, vocab)
        audio = stream_audio(1, 48000, SEED + 3)[0]
        pcm.write_bytes(audio.astype("<i2").tobytes())
        log(f"[5 cli] wrote {gguf.stat().st_size / 1e9:.2f} GB F16 GGUF in "
            f"{time.perf_counter() - t0:.1f} s")

        model = ASRModel.from_gguf(str(gguf), device="cuda")
        for mode, block in ((0, True), (13, False)):
            sess = StreamSession(model, CacheConfig.for_mode(mode, model.hp))
            kernels.reset_counts()
            text = "".join(sess.process_incremental(audio[i:i + 1280])
                           for i in range(0, len(audio), 1280))
            text += sess.finalize() + "\n"
            torch.cuda.synchronize()
            chunks = sess.total_chunks
            counts = {k.name: k.launches for k in kernels.KERNELS}
            log(f"[5 cli] in-process StreamSession R={mode}, no block: "
                f"{chunks} chunks, {len(text.strip())} chars, launches "
                f"{counts}")
            runs.append((mode, block, False, text, chunks))
        runs.append(runs[0][:2] + (True,) + runs[0][3:])
        del sess, model
        torch.cuda.empty_cache()

        for i, (mode, block, eager, text, chunks) in enumerate(runs):
            env = dict(os.environ)
            env.pop("NEMOTRON_TPU_PALLAS_ATTN_BLOCK", None)
            if block:
                env["NEMOTRON_TPU_PALLAS_ATTN_BLOCK"] = "1"
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-c", CLI_RUNNER,
                 *(["--eager"] if eager else []), "transcribe_stream",
                 str(gguf), str(pcm), "80", str(mode)], cwd=root, env=env,
                capture_output=True, text=True, timeout=600)
            runs[i] += (out, time.perf_counter() - t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rtfs = {}
    for mode, block, eager, text, chunks, out, secs in runs:
        rtf = [ln for ln in out.stderr.splitlines() if "RTF: " in ln]
        got = [ln for ln in out.stderr.splitlines()
               if ln.startswith("KERNEL_LAUNCHES ")]
        sub = json.loads(got[-1].split(" ", 1)[1]) if got else {}
        want_b3 = L * chunks if block else 0
        if mode == 0:
            rtfs[eager] = rtf[-1].strip() if rtf else None
        log(f"[{'10' if eager else '5'} cli] python -m "
            f"nemotron_tpu_torch.cli.transcribe_stream ... 80 {mode}"
            f"{' with NEMOTRON_TPU_PALLAS_ATTN_BLOCK=1' if block else ''}"
            f"{', every tick eager' if eager else ', graphed'}: "
            f"rc {out.returncode} in {secs:.1f} s; stdout equal to the "
            f"session's: {out.stdout == text}; "
            f"{rtf[-1].strip() if rtf else 'no RTF line'}; launches {sub} "
            f"(want t1_attention_block {want_b3}, t1_attention 0)")
        if out.returncode != 0 or out.stdout != text or not rtf \
                or not chunks or sub.get("t1_attention_block") != want_b3 \
                or sub.get("t1_attention") != 0 \
                or not sub.get("mel_frames") or not text.strip():
            raise SystemExit(
                f"phase 5 (cli R={mode}): the CLI run does not match:\n"
                f"stdout {out.stdout!r}\nsession {text!r}\nstderr "
                f"{out.stderr[-3000:]}")
    log(f"[10 cli] R=0 with the block, 3.0 s: stdout equal eager and "
        f"graphed; graphed {rtfs[False]} | eager {rtfs[True]}")
    return rtfs


def quant_bytes(model) -> int:
    """Bytes of the quantized encoder weights (codes and scales, all
    layers): what one tick reads of them."""
    from nemotron_tpu_torch.ops.quant import is_quantized

    total = 0
    for f in dataclasses.fields(model.params.layers):
        w = getattr(model.params.layers, f.name)
        if is_quantized(w):
            total += sum(t.numel() * t.element_size()
                         for t in dataclasses.astuple(w))
    return total


# (model, batch, right context) of the timed and profiled ticks
TICK_TIMES = (("f32", 32, 0), ("f32", 256, 0), ("bf16", 256, 0),
              ("bf16 int8-KV", 256, 0), ("bf16 Q8_0 int8-KV", 256, 0),
              ("bf16 Q4_0", 256, 0), ("f32 Q8_0 int8-KV", 256, 0),
              ("f32 block", 256, 0), ("bf16 block", 256, 0),
              ("bf16 int8-KV block", 256, 0), ("f32", 256, 6),
              ("f32", 256, 13), ("bf16 int8-KV", 256, 6),
              ("bf16 int8-KV", 256, 13))
DECODE_AT_R0 = (("f32", 256), ("bf16 int8-KV", 256))


def tick_row(torch, model, b: int, mode: int, n_time: int, n_prof: int):
    """One TickLoop of all-active ticks at batch b, right context `mode`:
    the median host ms of n_time ticks (synchronised before and after
    each) after 4 warm-up ticks (and, graphed, after every key's warm-up
    and capture), then profile_rows of n_prof more ticks of the same loop
    (a graphed model replays what it captured)."""
    loop = TickLoop(model, b, mode)
    warm = 4 + graph_warmup(model, loop.cfg)
    times = []
    for i in range(warm + n_time):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        if i >= warm:
            times.append((time.perf_counter() - t0) * 1e3)
    prof = profile_rows(torch, loop, n_prof, 0)
    del loop
    torch.cuda.empty_cache()
    return statistics.median(times), prof


def phase_tick_times(torch, models, card: str) -> list:
    """Phase 10's tick table: fused_tick_packed at full width, all-active,
    in turns eager (a twin with graphs=False) and graphed (the model):
    host ms per tick, the device's kernel time per tick from a profile of
    the same loop, its idle share, real-time streams (B x the chunk period
    (shift_mel_frames x 10 ms: 80 / 160 / 560 / 1,120 ms at right context
    0 / 1 / 6 / 13) / tick ms), and the graphed keys' captures, capture
    seconds and pool bytes; eager, the kernels of the tick's decode half
    alone and the kernels' rows. Returns the table's rows."""
    from nemotron_tpu_torch.tools.graph_turns import twin

    table = []
    for name, b, mode in TICK_TIMES:
        graphed = models[name]
        cfg = graphed.cache_config(mode)
        period = cfg.shift_mel_frames * 10.0
        # past R=0 a tick issues 3-6x the kernels: fewer ticks, timed and
        # traced, keep the phase inside its time
        n_time, n_prof = (6, 3) if mode == 0 else (3, 1)
        row = {"config": name, "B": b, "R": mode}
        for form, model in (("eager", twin(graphed)),
                            ("graphed", graphed)):
            ms, prof = tick_row(torch, model, b, mode, n_time, n_prof)
            busy = prof[0] if prof else None
            row[form] = {
                "ms": round(ms, 3), "streams": round(period / ms * b),
                "busy_ms": None if busy is None else round(busy, 3),
                "idle": (None if busy is None
                         else round(max(0.0, 1 - busy / ms), 3)),
                "kernels": (None if prof is None
                            else round(sum(r[2] for r in prof[1])))}
            log(f"[10 tick] B={b} R={mode} all-active {name} {form}: "
                f"{ms:.2f} ms/tick, {period / ms * b:.0f} real-time "
                f"{period:.0f} ms streams; device busy "
                + (f"{busy:.2f} ms (idle share {max(0.0, 1 - busy / ms):.2f}"
                   f"), {row[form]['kernels']} kernels/tick"
                   if prof else "not measured (no device events)")
                + f" ({card})")
            if form == "eager" and prof:
                tick_profile_rows(model, name, b, mode, prof[1], card)
        if mode or (name, b) in DECODE_AT_R0:  # the decode half alone
            dec = profile_decode(torch, graphed, b, n_prof, mode)
            if dec is not None:
                log(f"[10 profile] {name} B={b} R={mode}: decode half alone "
                    f"{sum(r[2] for r in dec[1]):.0f} kernels, {dec[0]:.2f} "
                    f"ms device ({cfg.chunk_len(graphed.hp) * 11 + 1} loop "
                    f"iterations) ({card})")
        gs = graphed.graphs.stats(
            lambda key, c=cfg, b=b: key[:3] == ("tick_packed", c, b))
        row["graphs"] = {"captures": gs["captures"],
                         "capture_s": round(gs["capture_seconds"], 3),
                         "pool_MB": round(gs["pool_bytes"] / 2 ** 20, 1)}
        log(f"[10 graphs] {name} B={b} R={mode}: {json.dumps(row)}")
        graphed.graphs.clear()  # its pool goes before the next config's
        torch.cuda.empty_cache()
        table.append(row)
    return table


def tick_profile_rows(model, name, b, mode, rows, card):
    """The eager tick's profile rows: the top kernels, B2, B1's K/V rate,
    B3, B4/B5's weight rate."""
    from nemotron_tpu_torch.ops.kvquant import is_quant

    for kname, kms, calls in rows[:8]:
        log(f"[10 profile]   {kms:7.3f} ms/tick {calls:6.1f} calls  "
            f"{kname[:90]}")
    cfg = model.cache_config(mode)
    mel = [r for r in rows if "mel_frames" in r[0]]
    if mel:
        log(f"[10 profile] {name} B={b} R={mode}: B2 "
            f"{sum(r[1] for r in mel):.4f} ms/tick over "
            f"{sum(r[2] for r in mel):.2f} launches ({card})")
    hp = model.hp
    attn = [r for r in rows if "t1_attention" in r[0]]
    if attn:
        per_launch = attn[0][1] / attn[0][2]
        state = model.init_stream_state(1, cfg)  # the cache's own types
        row = (hp.d_head + 4 if is_quant(state.k_cache)
               else hp.d_head * state.k_cache.element_size())
        kv_bytes = 2 * b * hp.n_heads * cfg.cache_buf_len(hp) * row
        log(f"[10 profile] {name} B={b}: t1_attention "
            f"{per_launch * 1e3:.1f} us per launch, "
            f"{kv_bytes / per_launch / 1e6:.0f} GB/s of K/V "
            f"({kv_bytes / 1e6:.1f} MB per layer) ({card})")
    block = [r for r in rows if "DenseW" in r[0] or "ln_stats" in r[0]
             or "gemm_dense_sm90" in r[0]
             or "block_attention_kernel" in r[0]]
    if block:  # B3: its two GEMMs and its attention launch
        log(f"[10 profile] {name} B={b}: attention block (B3) "
            f"{sum(r[1] for r in block):.3f} ms/tick over "
            f"{sum(r[2] for r in block):.0f} launches ({card})")
    gemm = [r for r in rows if "wq::gemm" in r[0] and r not in block]
    if gemm:
        g_ms = sum(r[1] for r in gemm)
        wbytes = quant_bytes(model)
        log(f"[10 profile] {name} B={b}: quantized linears (B4/B5) "
            f"{g_ms:.3f} ms/tick over {sum(r[2] for r in gemm):.0f} "
            f"launches, {wbytes / g_ms / 1e6:.0f} GB/s of weights "
            f"({wbytes / 1e9:.3f} GB per tick) ({card})")


def offline_model(model, bias: float):
    """`model` with the joint's blank bias at `bias` instead of BLANK_BIAS
    (a copy of that one bias; every other weight shared)."""
    from nemotron_tpu_torch.api import ASRModel

    p = model.params
    ob = p.joint.out_b.clone()
    ob[model.hp.blank_id] += bias - BLANK_BIAS
    params = dataclasses.replace(
        p, joint=dataclasses.replace(p.joint, out_b=ob))
    return ASRModel(model.hp, params, model.tokenizer.vocab,
                    device=model.device)


def ragged_batch(model, audios):
    """The mels of `audios` through `model`'s frontend, zero-padded to the
    longest (no bucket): (mel [B, T, n_mels], n_mel [B], n_sub [B]) as
    numpy."""
    from nemotron_tpu_torch.audio.frontend import (StreamPreprocessor,
                                                   process_many)

    pre = model.params.preproc
    mels = process_many([StreamPreprocessor(pre.filterbank, pre.window)
                         for _ in audios], audios)
    n_mel = np.array([m.shape[0] for m in mels], np.int32)
    x = np.zeros((len(mels), n_mel.max(), mels[0].shape[1]), np.float32)
    for i, m in enumerate(mels):
        x[i, :m.shape[0]] = m
    return x, n_mel, np.array([model.hp.subsampled_len(n) for n in n_mel],
                              np.int32)


def offline_outputs(model, x, n_mel, n_sub):
    """encode_batch's valid rows (one f32 CPU tensor, row after row) and
    the tokens (numpy) of the block decode with its exit, as
    transcribe_batch runs them, of one ragged batch (eagerly)."""
    import torch

    from nemotron_tpu_torch.models import decoder as dec
    from nemotron_tpu_torch.models.asr import DECODE_EXIT_EVERY
    from nemotron_tpu_torch.models.encoder import encode_batch

    hp, p = model.hp, model.params
    n_valid = model.put_batch(n_sub)
    enc = encode_batch(p, hp, model.put_batch(x), n_frames=n_valid,
                       n_mel_frames=model.put_batch(n_mel))
    b, t = enc.shape[:2]
    carry = dec.init_carry(b, t, hp, enc.dtype, device=enc.device)
    state = dec.init_decode_state(b, hp, dtype=enc.dtype, device=enc.device)
    dec.start_carry(carry, state, n_valid)
    carry.enc_proj.copy_(dec.enc_projection(p.joint, enc))
    dec.decode_in_blocks(
        carry, t, int(n_sub.max()), DECODE_EXIT_EVERY,
        lambda: dec.decode_block(p, hp, carry, DECODE_EXIT_EVERY))
    tokens = dec.carry_result(carry, state, n_valid, t)[1]
    enc = enc.float().cpu()
    return (torch.cat([enc[i, :n] for i, n in enumerate(n_sub)]),
            tokens.cpu().numpy())


def phase_offline_parity(torch, cpu, gpu):
    """The offline path at full width, card against CPU, on a ragged batch
    of a 3 s and a 6 s file (the same host mel on both, from the CPU's
    frontend): f32 encode_batch's valid rows within F32_ATOL and tokens
    equal, and transcribe_audios' texts (each device's own frontend, B2 on
    the card) equal; bf16 within BF16_VS_REF x bf16's own error (the CPU's
    bf16 run against its f32 run); f32 Q8_0 (B4 on the card, the plain
    version on the CPU) within F32_ATOL with tokens equal. cpu and gpu map
    "f32", "bf16", "f32 Q8_0" to models."""
    audios = [stream_audio(1, 48000, SEED + 4)[0],
              stream_audio(1, 96000, SEED + 5)[0]]
    x, n_mel, n_sub = ragged_batch(cpu["f32"], audios)
    outs, bad = {}, []
    for name in ("f32", "bf16", "f32 Q8_0"):
        t0 = time.perf_counter()
        outs[name] = [offline_outputs(m[name], x, n_mel, n_sub)
                      for m in (cpu, gpu)]
        (enc_c, tok_c), (enc_g, tok_g) = outs[name]
        err = float((enc_g - enc_c).abs().max())
        finite = bool(torch.isfinite(enc_g).all())
        n_diff = int((tok_g != tok_c).sum())
        if name == "bf16":
            own = float((enc_c - outs["f32"][0][0]).abs().max())
            rule = f"<= {BF16_VS_REF:g} x bf16's own {own:.3e}"
            good = finite and err <= BF16_VS_REF * own
            tok_note = (f"token cells equal to the f32 CPU run: card "
                        f"{float((tok_g == outs['f32'][0][1]).mean()):.3f}, "
                        f"cpu {float((tok_c == outs['f32'][0][1]).mean()):.3f}")
        else:
            rule = f"<= {F32_ATOL:g}"
            good = finite and err <= F32_ATOL and n_diff == 0
            tok_note = f"token cells differing {n_diff} of {tok_c.size} (want 0)"
        if not good:
            bad.append(f"{name}: {err:.3e} {rule}, {tok_note}")
        log(f"[6 offline] {name} ragged batch of {n_mel.tolist()} mel frames "
            f"({n_sub.tolist()} encoder frames): encode_batch max|card - cpu| "
            f"{err:.3e} ({rule}); {tok_note}; "
            f"{int((tok_c >= 0).sum())} tokens on the CPU; "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    texts = [m["f32"].transcribe_audios(audios) for m in (cpu, gpu)]
    log(f"[6 offline] f32 transcribe_audios of the same two files: texts "
        f"equal card and CPU: {texts[0] == texts[1]} (chars "
        f"{[len(t) for t in texts[1]]}); {time.perf_counter() - t0:.1f} s")
    if texts[0] != texts[1] or not any(texts[0]):
        bad.append(f"texts {texts}")
    if bad:
        raise SystemExit(f"phase 6 (offline): card and CPU disagree: {bad}")
    return audios


def phase_offline_launches(torch, models, audios) -> dict:
    """The offline main path's launch counts: transcribe_audios of two
    files with Q8_0 and with Q4_0 encoder matrices (bf16), each model's
    offline keys first warmed up and captured in two calls, then the
    counts set to 0 just before a third call of each (every key replayed)
    and read just after: B2 once per call, B4 and B5 264 (11 matrices x
    24 layers) per segment through the replays, B1 and B3 never."""
    from nemotron_tpu_torch import kernels

    names = ("bf16 Q8_0", "bf16 Q4_0")
    for name in names:
        for _ in range(2):
            models[name].transcribe_audios(audios)
    torch.cuda.synchronize()
    kernels.reset_counts()
    for name in names:
        models[name].transcribe_audios(audios)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in kernels.KERNELS}
    hows = [how for name in names for seg in models[name].offline_stats
            for how in seg["graphs"].values()]
    replayed = all(how["replays"] == how["calls"] for how in hows)
    n_q = 11 * models["bf16 Q8_0"].hp.n_layers
    want = {"mel_frames": 2, "q8_matmul": n_q, "q4_matmul": n_q,
            "t1_attention": 0, "t1_attention_block": 0, "kv_rows": 0}
    log(f"[6 offline] launches of transcribe_audios, one segment each, "
        f"bf16 Q8_0 then bf16 Q4_0, every offline key replayed ({replayed}:"
        f" {hows}): {counts} (want {want})")
    if counts != want or not replayed:
        raise SystemExit(f"phase 6 (offline): launches {counts}, want {want};"
                         f" keys {hows}")
    for name in names:
        models[name].drop_offline_graphs()
    return counts


def offline_graphs(model) -> dict:
    """Each offline key's captures, capture s, pool MB and replays."""
    from nemotron_tpu_torch.api import OFFLINE_KEYS

    return {str(key): {"captures": e.captures,
                       "capture_s": round(e.capture_seconds, 3),
                       "pool_mb": round(e.pool_bytes / 1e6, 1),
                       "replays": e.replays}
            for (key, _shard), e in model.graphs.entries.items()
            if key[0] in OFFLINE_KEYS}


def offline_parity(torch, graphed, eager, mels):
    """One more _transcribe_mels of `mels` on each model, graphed first:
    (token ids and frames and the final decoder state's leaves compared
    bit for bit; each call's outputs; each call's host seconds)."""
    import dataclasses as dc

    outs, states, secs = [], [], []
    for m in (graphed, eager):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, state = m._transcribe_mels(mels, None)
        secs.append(time.perf_counter() - t0)
        outs.append(out)
        states.append([getattr(state, f.name) for f in dc.fields(state)])
    return {"ids_equal": outs[0] == outs[1],
            "state_equal": all(torch.equal(x, y) for x, y in zip(*states)),
            "tokens": sum(len(ids) for ids, _ in outs[0])}, outs, secs


def phase_offline_long(torch, model):
    """A file past one segment (LONG_SAMPLES, 17,000 mel frames: 16,376 +
    624) beside a 5 s one, on the card: transcribe_audios of the two equal
    to transcribe_audio of each, with word timestamps (the decoder state
    carried across the segment boundary, the short file's rows padded);
    the model at CAP_BIAS, where every frame emits. Then graphed against
    eager (`twin`): the batch's keys captured in the next call and
    replayed in offline_parity's, whose ids (and texts) and final decoder
    state are bit-equal to the eager call's; the
    second segment calls the first one's decode key. The offline graphs
    are dropped at the end."""
    from nemotron_tpu_torch import kernels
    from nemotron_tpu_torch.audio.frontend import process_many
    from nemotron_tpu_torch.tools.graph_turns import twin

    long = stream_audio(1, LONG_SAMPLES, SEED + 6)[0]
    short = stream_audio(1, 80000, SEED + 7)[0]
    kernels.reset_counts()
    t0 = time.perf_counter()
    batch = model.transcribe_audios([long, short], timestamp_words=True)
    torch.cuda.synchronize()
    t_batch, segs = time.perf_counter() - t0, model.offline_stats
    t0 = time.perf_counter()
    per = [model.transcribe_audio(a, timestamp_words=True)
           for a in (long, short)]
    torch.cuda.synchronize()
    t_per = time.perf_counter() - t0
    mel = kernels.MEL_FRAMES.launches
    its = sum(s["iterations"] for s in segs)
    log(f"[6 offline] f32 {LONG_SAMPLES / 16000:.1f} s + 5.0 s files, "
        f"blank bias {CAP_BIAS:g}: transcribe_audios in {t_batch:.2f} s "
        f"(its keys' first calls; segments {segs}; {t_batch / its * 1e3:.3f}"
        f" ms of host per decode iteration at most) equal to "
        f"transcribe_audio of each ({t_per:.2f} s): {batch == per}; chars "
        f"{[len(t) for t in batch]}, timestamps "
        f"{[t.count('{') for t in batch]}; B2 launches {mel} (want 3)")
    if batch != per or len(segs) != 2 or mel != 3 \
            or not all("{" in t for t in batch):
        raise SystemExit(f"phase 6 (offline, long file): batch {batch!r:.300}"
                         f" != per file {per!r:.300}, segments {segs}, "
                         f"B2 launches {mel}")
    eager = twin(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    captured = model.transcribe_audios([long, short], timestamp_words=True)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    pre = model._preprocessor
    same, outs, secs = offline_parity(torch, model, eager, process_many(
        [pre(), pre()], [long, short]))
    segs = model.offline_stats  # the parity call's: every key replayed
    texts = [[m.tokenizer.decode(ids, True, frames) for ids, frames in out]
             for m, out in zip((model, eager), outs)]
    dec_keys = [k for s in segs for k in s["graphs"] if k[0] != "batch"]
    replayed = all(how["replays"] == how["calls"] for s in segs
                   for how in s["graphs"].values())
    gs = model.graphs.stats()
    # the batch's keys; the per-file call's B=1 long segment ran once
    captured_once = all(model.graphs.entries[k, 0].captures == 1
                        for s in segs for k in s["graphs"])
    log(f"[6 offline long] graphed against eager: host s of the capture "
        f"call {t_capture:.2f}, of the parity calls replay "
        f"{secs[0]:.2f}, eager {secs[1]:.2f}; texts equal "
        f"{texts[0] == texts[1] == captured == batch}; {same}; the replay "
        f"call's keys {[s['graphs'] for s in segs]} (one decode key for "
        f"both segments: {len(set(dec_keys)) == 1}); graphs "
        f"{json.dumps(offline_graphs(model))}")
    if not (texts[0] == texts[1] == captured == batch
            and same["ids_equal"] and same["state_equal"] and replayed
            and len(dec_keys) == 2 and len(set(dec_keys)) == 1
            and captured_once and not gs["recaptures"]):
        raise SystemExit(f"phase 6 (offline, long file): graphed and eager "
                         f"differ: {same}, keys {segs}, graphs {gs}")
    model.drop_offline_graphs()
    del eager
    torch.cuda.empty_cache()


def phase_offline_cli(torch, hp, dense, vocab, audios):
    """The offline CLI on the card: the phase's model (OFFLINE_BIAS) as an
    F16 GGUF (into the git-ignored _smoke/, deleted afterwards), two files
    through `python -m nemotron_tpu_torch.cli.transcribe` in a subprocess;
    its stdout must equal `name<TAB>text` of an in-process
    transcribe_audios of the same GGUF, its stderr show the RTF line, and
    its B2 launch once."""
    import os
    import shutil
    from pathlib import Path

    from nemotron_tpu_torch.api import ASRModel
    from nemotron_tpu_torch.params import save_gguf

    root = Path(__file__).resolve().parent
    work = root / "_smoke"
    work.mkdir(exist_ok=True)
    try:
        gguf = work / "offline_f16.gguf"
        save_gguf(str(gguf), hp, offline_model(
            ASRModel(hp, dense, vocab, device="cpu"), OFFLINE_BIAS).params,
            vocab)
        names = []
        for i, a in enumerate(audios):
            names.append(str(work / f"file{i}.pcm"))
            Path(names[-1]).write_bytes(a.astype("<i2").tobytes())
        model = ASRModel.from_gguf(str(gguf), device="cuda")
        want = "".join(f"{n}\t{t}\n" for n, t in
                       zip(names, model.transcribe_audios(audios)))
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", CLI_RUNNER, "transcribe", str(gguf),
             *names], cwd=root, env=dict(os.environ), capture_output=True,
            text=True, timeout=600)
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rtf = [ln for ln in out.stderr.splitlines() if "RTF: " in ln]
    got = [ln for ln in out.stderr.splitlines()
           if ln.startswith("KERNEL_LAUNCHES ")]
    sub = json.loads(got[-1].split(" ", 1)[1]) if got else {}
    log(f"[6 cli] python -m nemotron_tpu_torch.cli.transcribe <F16 gguf> "
        f"<2 files>: rc {out.returncode} in {secs:.1f} s; stdout equal to "
        f"the in-process transcribe_audios: {out.stdout == want}; "
        f"{rtf[-1].strip() if rtf else 'no RTF line'}; launches {sub}")
    if out.returncode != 0 or out.stdout != want or not rtf \
            or sub.get("mel_frames") != 1 or sub.get("t1_attention") != 0 \
            or "\t" not in want or not want.replace("\t", "").strip():
        raise SystemExit(f"phase 6 (offline cli): stdout {out.stdout!r}\n"
                         f"want {want!r}\nstderr {out.stderr[-3000:]}")


def time_offline(torch, graphed, audios, card: str, name: str,
                 n: int = 1, eager_busy: bool = True) -> dict:
    """`graphed` against its eager twin on `audios`, in turns within one
    call, after two calls of the graphed model (its offline keys warmed
    up, then captured): host seconds of one synchronised transcribe_audios
    call (median of n each; with n = 0 the parity call's, which starts
    from the mels), audio-s/s; one more call of each compared bit for bit
    (offline_parity) and the timed calls' texts equal; the
    device busy ms of one more call each (idle share = 1 - busy / host;
    the eager one only with eager_busy); the decode's iterations; peak
    device memory (and its part above what was allocated before: the
    other models stay resident); the offline keys' captures, capture s,
    pool MB, replays. The graphed model's offline graphs are dropped at
    the end."""
    from nemotron_tpu_torch.audio.frontend import process_many
    from nemotron_tpu_torch.tools.graph_turns import twin

    t_start = time.perf_counter()
    eager = twin(graphed)
    models = {"eager": eager, "graphed": graphed}
    secs = len(audios) * len(audios[0]) / 16000.0
    for _ in range(2):
        graphed.transcribe_audios(audios)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 1e9
    times = {"eager": [], "graphed": []}
    texts = []
    for i in range(n):
        for form in ("eager", "graphed")[::1 if i % 2 == 0 else -1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            texts.append(models[form].transcribe_audios(audios))
            torch.cuda.synchronize()
            times[form].append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    pre = graphed._preprocessor
    same, _, parity_s = offline_parity(
        torch, graphed, eager, process_many([pre() for _ in audios], audios))
    if not n:
        times = {"graphed": parity_s[:1], "eager": parity_s[1:]}
    row = {"name": name, "B": len(audios), "card": card, **same,
           "texts_equal": all(t == texts[0] for t in texts),
           "iterations": [s["iterations"] for s in graphed.offline_stats],
           "peak_gb": round(peak, 2),
           "above_resident_gb": round(peak - resident, 2),
           "graphs": offline_graphs(graphed)}
    for form, m in models.items():
        host = statistics.median(times[form])
        prof = (profile_rows(torch, lambda m=m: m.transcribe_audios(audios),
                             n=1, warmup=0)
                if form == "graphed" or eager_busy else None)
        busy = None if prof is None else prof[0] / 1e3
        row[form] = {"host_s": host, "times": times[form],
                     "audio_s_per_s": secs / host,
                     "busy_s": busy,
                     "idle": None if busy is None else max(0.0,
                                                           1 - busy / host),
                     "kernels_per_segment": None if prof is None else
                     sum(r[2] for r in prof[1]) / len(m.offline_stats)}
    gs = graphed.graphs.stats()
    log(f"[6 offline time] {name} B={len(audios)} x "
        f"{len(audios[0]) / 16000:.0f} s (its runs {time.perf_counter() - t_start:.0f}"
        f" s): host s per call eager "
        f"{row['eager']['host_s']:.3f}, graphed {row['graphed']['host_s']:.3f}"
        f" ({row['eager']['audio_s_per_s']:.1f} -> "
        f"{row['graphed']['audio_s_per_s']:.1f} audio-s/s); {json.dumps(row)}")
    if not (same["ids_equal"] and same["state_equal"]
            and row["texts_equal"]
            and gs["captures"] == gs["keys"] and not gs["recaptures"]):
        raise SystemExit(f"phase 6 (offline time, {name} B={len(audios)}): "
                         f"graphed and eager differ: {row}, graphs {gs}")
    graphed.drop_offline_graphs()
    del eager
    torch.cuda.empty_cache()
    return row


def phase_offline(torch, hp, dense, q8, vocab, gpu, card: str):
    """Phase 6, the offline path at full width: card against CPU, the
    main path's launch counts through graph replays, a file past one
    segment graphed against eager, the CLI, graphed against eager in
    turns with times. The card's models share the weights of phase 4-5's
    (`gpu`; their int8 K/V option does not touch the offline path); dense
    and q8 are the CPU's f32 and Q8_0 weights."""
    from nemotron_tpu_torch.api import ASRModel
    from nemotron_tpu_torch.params import params_to

    base = {"f32": gpu["f32"], "bf16": gpu["bf16"],
            "f32 Q8_0": gpu["f32 Q8_0 int8-KV"],
            "bf16 Q8_0": gpu["bf16 Q8_0 int8-KV"],
            "bf16 Q4_0": gpu["bf16 Q4_0"]}
    card_m = {k: offline_model(m, OFFLINE_BIAS) for k, m in base.items()}

    def cpu_m(params, dtype=None):
        return offline_model(ASRModel(hp, params_to(params, "cpu", dtype),
                                      vocab, device="cpu"), OFFLINE_BIAS)
    cpu = {"f32": cpu_m(dense), "bf16": cpu_m(dense, torch.bfloat16),
           "f32 Q8_0": cpu_m(q8)}
    audios = phase_offline_parity(torch, cpu, card_m)
    del cpu
    card_m["f32"].drop_offline_graphs()
    counts = phase_offline_launches(torch, card_m, audios)
    phase_offline_long(torch, offline_model(gpu["f32"], CAP_BIAS))
    phase_offline_cli(torch, hp, dense, vocab, audios)
    # bf16 Q4_0's random weights emit on these files (~11x the decode
    # iterations of the others, ~10 s per eager call): timed by its parity
    # calls alone, its eager busy not measured, at B=8 only (B=1 took
    # ~35 s; B5's form below 1,024 rows is held graphed = eager by phase
    # 10's bf16 Q4_0 parity ticks, M = 256)
    rows = [time_offline(torch, card_m[name],
                         list(stream_audio(b, OFFLINE_SECS * 16000,
                                           SEED + 10)), card, name,
                         **({"n": 0, "eager_busy": False}
                            if name == "bf16 Q4_0" else {}))
            for name in ("f32", "bf16", "bf16 Q8_0", "bf16 Q4_0")
            for b in ((8,) if name == "bf16 Q4_0" else (1, 8))]
    log(f"[6 offline table] {json.dumps(rows)}")
    return counts


# phase 7: the engine's surface at full width
SURF_B = 8          # the migration, event and legacy-flow engines' batch
SWAP_BATCHES = (64, 256)
TIMER_B, TIMER_WARM, TIMER_TICKS = 256, 4, 16


class Streams:
    """Streams of `audios` on engines, each pushing `first` samples on its
    first tick and `per_tick` after; texts and event checks by stream."""

    def __init__(self, audios, first: int, per_tick: int):
        self.audios, self.first, self.per_tick = audios, first, per_tick
        self.pos = [0] * len(audios)
        self.texts = [""] * len(audios)
        self.events = [[] for _ in audios]

    def push(self, engine, sids, which) -> None:
        for i in which:
            n = self.first if self.pos[i] == 0 else self.per_tick
            a = self.audios[i][self.pos[i]:self.pos[i] + n]
            if len(a):
                engine.push_audio(sids[i], a)
            self.pos[i] += n

    def take(self, events, sids) -> None:
        index = {sid: i for i, sid in enumerate(sids) if sid is not None}
        for e in events:
            i = index.get(e.stream_id)
            if i is not None:
                self.texts[i] += e.text
                self.events[i].append(e)

    def tick(self, engine, sids, which) -> None:
        self.push(engine, sids, which)
        self.take(engine.tick()[0], sids)

    def done(self, i) -> bool:
        return self.pos[i] >= len(self.audios[i])

    def finish(self, engine, sids, which) -> None:
        """Push what is left of `which`, end them and run the engine idle."""
        while not all(self.done(i) for i in which):
            self.tick(engine, sids, [i for i in which if not self.done(i)])
        for i in which:
            engine.end_stream(sids[i])
        for _ in range(400):
            events, more = engine.tick()
            self.take(events, sids)
            if not more:
                return
        raise SystemExit("phase 7: an engine did not go idle")


def kernel_counts() -> dict:
    from nemotron_tpu_torch import kernels

    return {k.name: k.launches for k in kernels.KERNELS}


def check_launches(name, counts, engines, model, b1_per_step: int):
    """B2 once per chunk step (a k-chunk dispatch is k steps), B1
    b1_per_step per step of the fast flow, B4 (Q8_0) and B5 (Q4_0) once
    per step for each quantized layer matrix (11 x 24 at full width),
    kv_rows at least once (the slot resets)."""
    from nemotron_tpu_torch.ops.quant import QuantizedTensor, QuantizedTensor4

    steps = sum(g.total_chunk_steps for e in engines
                for g in e.groups.values())
    layers = model.params.layers
    ws = [getattr(layers, f.name) for f in dataclasses.fields(layers)]
    per = model.hp.n_layers * steps
    want = {"mel_frames": steps, "t1_attention": b1_per_step * steps,
            "q8_matmul": per * sum(isinstance(w, QuantizedTensor)
                                   for w in ws),
            "q4_matmul": per * sum(isinstance(w, QuantizedTensor4)
                                   for w in ws),
            "t1_attention_block": 0}
    # kv_rows: every join resets its slot, every wrap compacts
    if {k: counts[k] for k in want} != want or not counts["kv_rows"]:
        raise SystemExit(f"phase 7 ({name}): launches {counts} over {steps} "
                         f"chunk steps, want {want} and kv_rows > 0")
    return steps


def phase_migrate(torch, model, name, mode, L, sizes):
    """Two streams of engine A (batch SURF_B) exported mid-flight at a phase
    other than 0, through snapshot_to_bytes / snapshot_from_bytes, into
    engine B, whose two decoys sit at another phase; every stream on
    either engine ends with the text of an unmigrated engine U run on the
    same pushes. At right context 13 A's batch is full and a k = n_phases
    backlog tick runs before the export."""
    from nemotron_tpu_torch import kernels
    from nemotron_tpu_torch.streaming.engine import (BatchedEngine,
                                                     PRIME_SAMPLES,
                                                     snapshot_from_bytes,
                                                     snapshot_to_bytes)

    cfg = model.cache_config(mode)
    shift = cfg.shift_samples
    n = SURF_B if mode else 4
    first = PRIME_SAMPLES + (cfg.n_phases if mode else 1) * shift
    n_before, n_after = (2, 3) if mode else (3, 12)  # ticks around export
    length = first + (n_before + n_after) * shift + 700
    audios = list(stream_audio(n, length, SEED + 20))
    decoys = list(stream_audio(2, first + 6 * shift, SEED + 21))
    s_u, s_a = Streams(audios, first, shift), Streams(audios, first, shift)
    # the importer's streams: its two decoys, then the two migrated ones
    s_b = Streams(decoys + audios[:2], PRIME_SAMPLES + shift, shift)
    kernels.reset_counts()
    t0 = time.perf_counter()
    eng_u, eng_a, eng_b = (BatchedEngine(model, SURF_B) for _ in range(3))
    sid_u = [eng_u.start_stream(mode) for _ in range(n)]
    sid_a = [eng_a.start_stream(mode) for _ in range(n)]
    sid_b = [eng_b.start_stream(mode) for _ in range(2)] + [None, None]
    for _ in range(2):
        s_b.tick(eng_b, sid_b, range(2))
    for _ in range(n_before):
        s_u.tick(eng_u, sid_u, range(n))
        s_a.tick(eng_a, sid_a, range(n))
    phase_a = eng_a.groups[mode].phase
    futs = [eng_a.request_export(sid_a[i]) for i in (0, 1)]
    t1 = time.perf_counter()
    s_a.take(eng_a.tick()[0], sid_a)  # the export tick
    t_export = time.perf_counter() - t1
    blobs = [snapshot_to_bytes(f.result(timeout=60)) for f in futs]
    snaps = [snapshot_from_bytes(b, model) for b in blobs]
    phase_b = eng_b.groups[mode].phase
    if {int(s["phase"]) for s in snaps} != {phase_a} or phase_a == 0 \
            or phase_a == phase_b:
        raise SystemExit(f"phase 7 ({name} R={mode}): export phase "
                         f"{phase_a}, importer phase {phase_b}")
    futs = [eng_b.request_import(s) for s in snaps]
    t1 = time.perf_counter()
    events = eng_b.tick()[0]  # the import tick
    t_import = time.perf_counter() - t1
    sid_b[2:] = [f.result(timeout=60) for f in futs]
    s_b.pos[2:], s_b.texts[2:] = s_a.pos[:2], s_a.texts[:2]
    s_b.take(events, sid_b)
    s_u.finish(eng_u, sid_u, range(n))
    s_a.finish(eng_a, sid_a, range(2, n))
    s_b.finish(eng_b, sid_b, range(4))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = s_b.texts[2:] + s_a.texts[2:]
    bad = [i for i in range(n) if got[i] != s_u.texts[i]]
    left = eng_a.stats()["streams"] + eng_b.stats()["streams"]
    counts = kernel_counts()
    steps = check_launches(f"{name} R={mode}", counts, (eng_u, eng_a, eng_b),
                           model, 0 if mode else L)
    sizes[f"{name} R={mode}"] = len(blobs[0])
    log(f"[7 migrate] {name} R={mode} B={SURF_B}: 2 of {n} streams exported "
        f"at phase {phase_a} ({len(blobs[0])} snapshot bytes per stream, "
        f"export tick {t_export * 1e3:.1f} ms, import tick "
        f"{t_import * 1e3:.1f} ms for both) into an engine at phase "
        f"{phase_b}; texts equal to the unmigrated run: {n - len(bad)} of "
        f"{n} ({sum(len(t) for t in got)} chars); launches {counts} over "
        f"{steps} chunk steps; {secs:.1f} s")
    if bad or left or not all(s_u.texts):
        raise SystemExit(f"phase 7 ({name} R={mode}): streams {bad} differ "
                         f"from the unmigrated run, {left} left over, or one "
                         f"is empty: {[len(t) for t in s_u.texts]}")
    return counts


def snapshot_sizes(torch, models, sizes):
    """snapshot_to_bytes' size of one stream of each form at right
    contexts 0 and 13 (fixed by the shapes)."""
    from nemotron_tpu_torch.streaming.engine import snapshot_to_bytes
    from nemotron_tpu_torch.streaming.state import extract_slot

    for name, model in models.items():
        for mode in (0, 13):
            key = f"{name} R={mode}"
            if key in sizes:
                continue
            state = model.init_stream_state(1, model.cache_config(mode))
            snap = {"version": 1, "state": extract_slot(state, 0),
                    "stage": np.zeros(0, np.int16), "tokens": [],
                    "token_frames": []}
            sizes[key] = len(snapshot_to_bytes(snap))
            del state


async def _swap_clients(model, new_models, audios, batch, push=3200):
    """len(audios) streams on one connection to a server of `batch` slots:
    each pushes the first half of its audio, the server hot-swaps to each
    of `new_models` in turn (none: no swap), the rest is pushed and every
    stream ends. Returns (texts, [(migrated, stall s, last_swap)])."""
    from nemotron_tpu_torch.serving import protocol as P
    from nemotron_tpu_torch.serving.client import StreamClient
    from nemotron_tpu_torch.serving.server import StreamServer

    srv = StreamServer(model, batch_per_group=batch)
    server = await srv.start("127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    try:
        client = await StreamClient.connect("127.0.0.1", port)
        sids = [await client.start_stream() for _ in audios]
        texts = {sid: "" for sid in sids}
        ended = set()

        async def receiver():
            while len(ended) < len(sids):
                op, sid, payload = await asyncio.wait_for(client.recv(),
                                                          timeout=300)
                if op in (P.OP_TEXT, P.OP_ENDED):
                    texts[sid] += payload.decode("utf-8", "replace")
                    if op == P.OP_ENDED:
                        ended.add(sid)
                elif op == P.OP_ERROR:
                    raise RuntimeError(payload.decode())

        recv = asyncio.ensure_future(receiver())
        cuts = np.linspace(0, len(audios[0]), len(new_models) + 2).astype(int)
        cuts = [c // push * push for c in cuts[1:-1]] + [len(audios[0])]
        swaps, lo = [], 0
        for k, hi in enumerate(cuts):
            for off in range(lo, hi, push):
                for sid, a in zip(sids, audios):
                    await client.push(sid, a[off:min(off + push, hi)])
            lo = hi
            if k < len(new_models):
                await asyncio.sleep(1.0)  # the engine takes up the audio
                t0 = time.perf_counter()
                n = await asyncio.wait_for(srv.hot_swap(new_models[k]),
                                           timeout=300)
                swaps.append((n, time.perf_counter() - t0,
                              dict(srv.last_swap)))
        for sid in sids:
            await client.send(P.OP_STREAM_END, sid)
        await asyncio.wait_for(recv, timeout=300)
        client.close()
        return [texts[s] for s in sids], swaps
    finally:
        await srv.stop(server)


def phase_hot_swap(torch, model, same, other, card):
    """Hot swap at full width in f32, R=0: at B=64 live clients get the same
    transcripts byte for byte through a swap to the same weights; a swap
    to other weights still ends every stream; at B=256 one swap to the
    same weights is timed. Stall: host seconds from hot_swap's call to
    its return."""
    out = {}
    for b in SWAP_BATCHES:
        audios = list(stream_audio(b, 48000, SEED + 30))
        runs = ((None, []), ("same", [same]), ("other", [other])) \
            if b == SWAP_BATCHES[0] else (("same", [same]),)
        texts = {}
        for kind, news in runs:
            t0 = time.perf_counter()
            texts[kind], swaps = asyncio.run(
                _swap_clients(model, news, audios, b))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            for n, stall, info in swaps:
                log(f"[7 swap] B={b} f32 R=0 to the {kind} weights: {n} "
                    f"streams migrated, stall {stall * 1e3:.0f} ms (export "
                    f"{info['export_seconds'] * 1e3:.0f} ms, import "
                    f"{info['import_seconds'] * 1e3:.0f} ms), "
                    f"{info['snapshot_bytes'] / 1e9:.3f} GB of snapshots "
                    f"({info['snapshot_bytes'] / max(n, 1) / 1e6:.2f} MB "
                    f"per stream) ({card})")
                out[f"B={b} {kind}"] = {"streams": n, "stall_s": stall,
                                       **info}
                if n != b:
                    raise SystemExit(f"phase 7 (swap B={b}): {n} of {b} "
                                     f"streams migrated")
            log(f"[7 swap] B={b} {kind or 'no swap'}: {b} streams ended, "
                f"{sum(len(t) for t in texts[kind])} chars in {secs:.1f} s")
        if None in texts and texts["same"] != texts[None]:
            bad = [i for i, (x, y) in enumerate(zip(texts["same"],
                                                     texts[None])) if x != y]
            raise SystemExit(f"phase 7 (swap B={b}): streams {bad} differ "
                             f"from the run without a swap")
        if None in texts and not all(texts[None]):
            raise SystemExit(f"phase 7 (swap B={b}): empty transcripts")
    return out


def phase_events(torch, model, conf_model):
    """Events of a confidence=True engine: at_sec >= 0 and non-decreasing
    per stream, conf in (0, 1] on every text event; the texts equal a
    confidence=False engine's."""
    from nemotron_tpu_torch.streaming.engine import (BatchedEngine,
                                                     PRIME_SAMPLES)

    audios = list(stream_audio(4, 40000, SEED + 40))
    runs = {}
    for m in (model, conf_model):
        s = Streams(audios, PRIME_SAMPLES + 1280, 1600)
        engine = BatchedEngine(m, SURF_B)
        sids = [engine.start_stream(0) for _ in audios]
        s.finish(engine, sids, range(len(audios)))
        runs[m.confidence] = s
    bad = []
    confs = []
    for i, evs in enumerate(runs[True].events):
        last = 0.0
        for e in evs:
            if e.text:
                confs.append(e.conf)
                if not (0.0 < e.conf <= 1.0 and e.at_sec >= last):
                    bad.append((i, e.at_sec, e.conf))
                last = e.at_sec
    log(f"[7 events] confidence=True engine, 4 streams x 2.5 s, B={SURF_B}: "
        f"{len(confs)} text events, conf min {min(confs, default=-1):.4f} "
        f"median {float(np.median(confs)) if confs else -1:.4f}; texts "
        f"equal to the confidence=False engine's: "
        f"{runs[True].texts == runs[False].texts}")
    if bad or not confs or runs[True].texts != runs[False].texts \
            or any(e.conf != -1.0 for evs in runs[False].events
                   for e in evs):
        raise SystemExit(f"phase 7 (events): {bad[:5]} or texts differ")


# per round, the chunks each of 4 patterns pushes (0: it starves, pauses);
# stream i of SURF_B follows pattern i % 4
STAGGER = [(1, 0, 0, 0), (1, 1, 0, 0), (1, 0, 1, 1), (0, 0, 1, 1),
           (1, 1, 1, 1), (2, 0, 1, 0), (1, 3, 0, 2), (0, 2, 2, 1),
           (1, 1, 1, 1), (3, 3, 3, 3)]


def phase_flows(torch, model, L):
    """The fast flow, the legacy flow (gated_realign=False) and the phase
    timers (phase_timers=True) on one staggered join / pause schedule of
    SURF_B streams at B=SURF_B, f32, R=0: equal texts; B1 on every chunk
    step of the fast flow, and in the other two on the all-active ones
    only (none on a legacy gated tick); B2 once per chunk step."""
    from nemotron_tpu_torch.streaming.engine import (BatchedEngine,
                                                     PRIME_SAMPLES)

    audios = list(stream_audio(SURF_B, 30000, SEED + 50))
    texts, lines = {}, []
    for flow, kw in (("fast", {}), ("legacy", {"gated_realign": False}),
                     ("phase timers", {"phase_timers": True})):
        engine = BatchedEngine(model, SURF_B, **kw)
        calls = []  # (all active, B1, B2 launches) per dispatch
        for fn in ("fused_tick_packed", "fused_tick_profiled"):
            orig = getattr(model, fn)

            def spy(cfg, state, x, *a, _orig=orig, _fn=fn, **k):
                c0 = kernel_counts()
                out = _orig(cfg, state, x, *a, **k)
                c1 = kernel_counts()
                all_active = (a[0] if _fn == "fused_tick_packed"
                              else a[1] is None)
                calls.append((all_active,
                              c1["t1_attention"] - c0["t1_attention"],
                              c1["mel_frames"] - c0["mel_frames"]))
                return out
            setattr(model, fn, spy)
        try:
            s = Streams(audios, PRIME_SAMPLES, 1280)
            sids = [None] * SURF_B
            for rnd in STAGGER:
                for i in range(SURF_B):
                    k = rnd[i % 4]
                    if k and sids[i] is None:
                        sids[i] = engine.start_stream(0)
                    if k:
                        n = k * 1280 + (PRIME_SAMPLES if s.pos[i] == 0
                                        else 0)
                        engine.push_audio(sids[i],
                                          s.audios[i][s.pos[i]:s.pos[i] + n])
                        s.pos[i] += n
                for _ in range(2):
                    s.take(engine.tick()[0], sids)
            s.finish(engine, sids, range(SURF_B))
        finally:
            for fn in ("fused_tick_packed", "fused_tick_profiled"):
                delattr(model, fn)
        texts[flow] = s.texts
        g = engine.groups[0]
        gated = [c for c in calls if not c[0]]
        b1_gated = sum(c[1] for c in gated)
        b1_all = sum(c[1] for c in calls)
        b2 = sum(c[2] for c in calls)
        lines.append(f"{flow}: {len(calls)} dispatches ({len(gated)} with "
                     f"paused slots), {g.total_chunk_steps} chunk steps, B1 "
                     f"{b1_all} ({b1_gated} on the ticks with paused slots), "
                     f"B2 {b2}")
        all_steps = g.total_chunk_steps - len(gated)
        want_b1 = L * (g.total_chunk_steps if flow == "fast" else all_steps)
        if b2 != g.total_chunk_steps or b1_all != want_b1 or not gated \
                or not all_steps:
            raise SystemExit(f"phase 7 (flows): {lines[-1]}; want B1 "
                             f"{want_b1}")
    log(f"[7 flows] f32 R=0 B={SURF_B}, {SURF_B} streams joining and "
        f"pausing: " + "; ".join(lines) + "; texts equal to the fast "
        f"flow's: " + str([texts[f] == texts["fast"] for f in texts]))
    if any(texts[f] != texts["fast"] for f in texts) \
            or not all(texts["fast"]):
        raise SystemExit("phase 7 (flows): the legacy flow or the phase "
                         "timers change a transcript")


def phase_timers(torch, model, name, card, tag="7 timers"):
    """phase_timers=True at B=TIMER_B, R=0, every slot busy: the engine's
    encoder_seconds / decoder_seconds per tick over TIMER_TICKS ticks
    after TIMER_WARM (and, graphed, after each half's keys were warmed up
    and captured), then each half's device busy share: its kernels'
    device time (profile_rows of the half alone on the same shapes) over
    its host time."""
    from nemotron_tpu_torch.models import asr
    from nemotron_tpu_torch.streaming.engine import (BatchedEngine,
                                                     PRIME_SAMPLES)

    cfg = model.cache_config(0)
    warm = TIMER_WARM + graph_warmup(model, cfg)
    n_ticks = warm + TIMER_TICKS
    audios = stream_audio(TIMER_B, PRIME_SAMPLES + n_ticks * 1280 + 100,
                          SEED + 60)
    engine = BatchedEngine(model, TIMER_B, phase_timers=True)
    sids = [engine.start_stream(0) for _ in range(TIMER_B)]
    for sid, a in zip(sids, audios):
        engine.push_audio(sid, a)
    g = None
    phases = ("engine.encoder", "engine.decoder", "engine.tick")
    for i in range(n_ticks):
        if i == warm:
            g = engine.groups[0]
            base = [g.spans.seconds[p] for p in phases] + [g.total_steps]
        engine.tick()
    steps = g.total_steps - base[3]
    enc, dec, tick = ((g.spans.seconds[p] - b0) / steps * 1e3
                      for p, b0 in zip(phases, base))
    st = engine.stats()["groups"][0]
    del engine
    torch.cuda.empty_cache()

    hp = model.hp
    state = model.init_stream_state(TIMER_B, cfg)
    x = torch.tensor(audios[:, :1280], device=model.device)
    nv = torch.full((TIMER_B,), cfg.valid_out_len, dtype=torch.int32,
                    device=model.device)
    holder = {}

    def enc_half():
        holder["s"], holder["e"] = asr.fused_encode_tick(
            model.params, state, x, None, hp=hp, cfg=cfg, phase=0)

    def dec_half():
        asr.decode_tick(model.params, holder["s"], holder["e"], nv, hp=hp)
    enc_half()
    shares = []
    for fn, host in ((enc_half, enc), (dec_half, dec)):
        prof = profile_rows(torch, fn, 4, 2)
        shares.append("not measured" if prof is None else
                      f"{prof[0]:.2f} ms device ({prof[0] / host:.2f} busy, "
                      f"{sum(r[2] for r in prof[1]):.0f} kernels)")
    del state, holder
    torch.cuda.empty_cache()
    log(f"[{tag}] {name} B={TIMER_B} R=0 phase_timers=True, {steps} "
        f"ticks after {warm}: encoder {enc:.2f} ms/tick ({shares[0]}), "
        f"decoder {dec:.2f} ms/tick ({shares[1]}); decoder share "
        f"{dec / (enc + dec):.2f}; engine tick {tick:.2f} ms; stats "
        f"encoder_seconds {st['encoder_seconds']} decoder_seconds "
        f"{st['decoder_seconds']} ({card})")
    if not (enc > 0 and dec > 0):
        raise SystemExit(f"phase 7 (timers {name}): {enc}, {dec}")
    return {"encoder_ms": enc, "decoder_ms": dec}


def phase_surface(torch, hp, gpu, vocab, card):
    """Phase 7: the engine's surface at full width on the card."""
    from nemotron_tpu_torch.api import ASRModel

    L = hp.n_layers

    def share(name, **kw):
        return ASRModel(hp, gpu[name].params, vocab, device=gpu[name].device,
                        **kw)

    forms = {"f32": gpu["f32"], "bf16": gpu["bf16"],
             "f32 int8-KV": share("f32", kv_int8=True),
             "f32 Q8_0": share("f32 Q8_0 int8-KV"),
             "bf16 Q4_0": gpu["bf16 Q4_0"]}
    sizes, launches = {}, {}
    for name, m in forms.items():
        launches[name] = phase_migrate(torch, m, name, 0, L, sizes)
    launches["f32 R=13"] = phase_migrate(torch, gpu["f32"], "f32", 13, L,
                                         sizes)
    snapshot_sizes(torch, {k: forms[k] for k in ("f32", "bf16",
                                                 "f32 int8-KV")}, sizes)
    log(f"[7 migrate] snapshot bytes per stream {json.dumps(sizes)}")

    phase_events(torch, gpu["f32"], share("f32", confidence=True))
    phase_flows(torch, gpu["f32"], L)
    # other weights: the f32 model's with the joint's output rows reversed
    p = gpu["f32"].params
    other = ASRModel(hp, dataclasses.replace(p, joint=dataclasses.replace(
        p.joint, out_w=p.joint.out_w.flip(0).contiguous(),
        out_b=p.joint.out_b.flip(0).contiguous())), vocab,
        device=gpu["f32"].device)
    swaps = phase_hot_swap(torch, gpu["f32"], share("f32"), other, card)
    del other
    timers = {name: phase_timers(torch, gpu[name], name, card)
              for name in ("f32", "bf16")}
    return {"launches": launches, "snapshot_bytes": sizes, "swaps": swaps,
            "timers": timers}


# --- phase 8: diarization and the native ingest server ----------------------

DIAR_SEED = 7          # the random diarize checkpoint's weights
DIAR_SIGNAL_SEED = 8   # the 30 s pipeline signal (fixed: do not change)
DIAR_VAD_WINDOWS = 256
DIAR_SPK_WINDOWS = 64
DIAR_NMESC_N = 200     # embeddings of a long meeting
NATIVE_PACED = 64      # real-time paced clients on each server
NATIVE_PACED_SECS = 6


def write_random_diarize_gguf(path: str, seed: int = DIAR_SEED) -> None:
    """A random diarize.gguf (vad.* MarbleNet + spk.* TitaNet-L at the
    published widths) in the converter's tensor names and layouts, written
    with the port's GGUF writer. The same generator, draw for draw, as the
    tests' random diarize checkpoint, kept here so that the smoke needs
    nothing outside the port."""
    from nemotron_tpu_torch.diarize.params import SPK_TOPOLOGY, VAD_TOPOLOGY
    from nemotron_tpu_torch.gguf.writer import write_gguf

    rng = np.random.default_rng(seed)

    def r(*shape, scale=None):
        if scale is None:
            scale = 1.0 / np.sqrt(shape[-1]) if len(shape) > 1 else 0.05
        return rng.standard_normal(shape).astype(np.float32) * scale

    t: dict[str, np.ndarray] = {}

    def add_bn(prefix, c):
        t[f"{prefix}.weight"] = 1.0 + 0.1 * r(c)
        t[f"{prefix}.bias"] = 0.1 * r(c)
        t[f"{prefix}.running_mean"] = 0.1 * r(c)
        t[f"{prefix}.running_var"] = np.abs(r(c)) + 0.5

    def add_blocks(ns, topology, se_reduction=8):
        for b, (k, _dil, repeat, cin, cout, residual, separable, has_se) in \
                enumerate(topology):
            prefix = f"{ns}.encoder.encoder.{b}"
            c_in = cin
            for s in range(repeat):
                base = 5 * s
                if separable:
                    t[f"{prefix}.mconv.{base}.conv.weight"] = r(k, c_in,
                                                                scale=0.2)
                    t[f"{prefix}.mconv.{base + 1}.conv.weight"] = r(cout,
                                                                    c_in)
                    add_bn(f"{prefix}.mconv.{base + 2}", cout)
                else:
                    t[f"{prefix}.mconv.0.conv.weight"] = r(cout, c_in)
                    add_bn(f"{prefix}.mconv.1", cout)
                c_in = cout
            if residual:
                t[f"{prefix}.res.0.0.conv.weight"] = r(cout, cin)
                add_bn(f"{prefix}.res.0.1", cout)
            if has_se:
                se_idx = 5 * (repeat - 1) + 3
                t[f"{prefix}.mconv.{se_idx}.fc.0.weight"] = r(
                    cout // se_reduction, cout)
                t[f"{prefix}.mconv.{se_idx}.fc.2.weight"] = r(
                    cout, cout // se_reduction)

    add_blocks("vad", VAD_TOPOLOGY)
    add_blocks("spk", SPK_TOPOLOGY)
    t["vad.decoder.decoder_layers.0.weight"] = r(2, 128)
    t["vad.decoder.decoder_layers.0.bias"] = r(2)
    c_enc, attn_c, emb_dim = SPK_TOPOLOGY[-1][4], 128, 192
    dp = "spk.decoder"
    t[f"{dp}._pooling.attention_layer.0.conv_layer.weight"] = r(attn_c,
                                                                3 * c_enc)
    t[f"{dp}._pooling.attention_layer.0.conv_layer.bias"] = r(attn_c)
    add_bn(f"{dp}._pooling.attention_layer.0.bn", attn_c)
    t[f"{dp}._pooling.attention_layer.2.weight"] = r(c_enc, attn_c)
    t[f"{dp}._pooling.attention_layer.2.bias"] = r(c_enc)
    add_bn(f"{dp}.emb_layers.0.0", 2 * c_enc)
    t[f"{dp}.emb_layers.0.1.weight"] = r(emb_dim, 2 * c_enc)
    t[f"{dp}.emb_layers.0.1.bias"] = r(emb_dim)
    for ns in ("vad", "spk"):
        t[f"{ns}.preprocessor.featurizer.fb"] = rng.uniform(
            0, 1, (80, 257)).astype(np.float32)
        t[f"{ns}.preprocessor.featurizer.window"] = np.hanning(400).astype(
            np.float32)
    kv = {
        "general.architecture": "nemo-diarize",
        "general.name": "synthetic-diarize",
        "vad.sample_rate": 16000, "vad.n_mels": 80, "vad.n_fft": 512,
        "vad.window_size": 0.025, "vad.window_stride": 0.01,
        "vad.normalize": "None", "vad.window": "hann", "vad.n_classes": 2,
        "spk.sample_rate": 16000, "spk.n_mels": 80, "spk.n_fft": 512,
        "spk.window_size": 0.025, "spk.window_stride": 0.01,
        "spk.normalize": "per_feature", "spk.window": "hann",
        "spk.emb_dim": 192, "spk.attn_channels": 128,
    }
    write_gguf(path, kv, t)


def diarize_signal(seconds: int = 30, seed: int = DIAR_SIGNAL_SEED
                   ) -> np.ndarray:
    """Two 'speakers' taking turns of 3-5 s with 1 s pauses: a 250 Hz tone
    and a 2 kHz tone, each under noise, over a faint noise floor. The
    random VAD scores the turns above its onset (0.9) and the pauses below
    its offset (0.5), and no window of the signal lies close enough to either
    threshold for card-vs-CPU noise to move a segment's edge."""
    rng = np.random.default_rng(seed)
    out = 0.003 * rng.standard_normal(seconds * 16000)
    t, spk = 0.5, 0
    while t < seconds - 1.5:
        n0 = int(t * 16000)
        n1 = min(n0 + int(rng.uniform(3.0, 5.0) * 16000), len(out))
        tt = np.arange(n1 - n0) / 16000.0
        f, a = ((250.0, 0.3), (2000.0, 0.6))[spk]
        out[n0:n1] = (a * np.sin(2 * np.pi * f * tt)
                      + 0.2 * rng.standard_normal(n1 - n0))
        t = n1 / 16000.0 + 1.0
        spk ^= 1
    return np.clip(out, -1, 1).astype(np.float32)


def _pipeline_run(params, audio: np.ndarray, chunk: int = 16000):
    """`audio` through a DiarizePipeline on the params' device in pushes of
    `chunk`; returns (pipeline, result)."""
    from nemotron_tpu_torch.diarize.pipeline import DiarizePipeline

    p = DiarizePipeline(params)
    for off in range(0, len(audio), chunk):
        p.push_audio(audio[off:off + chunk])
    return p, p.finalize()


def phase_diarize_nets(torch, gpu, cpu, eager, card: str) -> None:
    """MarbleNet over DIAR_VAD_WINDOWS windows and TitaNet-L over
    DIAR_SPK_WINDOWS sub-segments (full and ragged lengths) on the card
    against the CPU in f32; their times; then each through
    DiarizePipeline._run graphed (gpu: one graph per net and bucket, three
    calls: warm-up, capture, replay) against eager (`eager`, graphs off):
    bit for bit, one capture per key, host ms per call both ways in
    turns; NME-SC's host time."""
    from nemotron_tpu_torch.diarize import audio as daudio
    from nemotron_tpu_torch.diarize.cluster import nmesc_cluster
    from nemotron_tpu_torch.diarize.nets import spk_embed, vad_probs
    from nemotron_tpu_torch.diarize.pipeline import DiarizePipeline

    sig = diarize_signal()
    rng = np.random.default_rng(SEED + 8)
    bad = {}
    for name, net, n, count, lens_lo in (
            ("vad", vad_probs, daudio.VAD_WINDOW_SAMPLES, DIAR_VAD_WINDOWS,
             daudio.VAD_WINDOW_SAMPLES),
            ("spk", spk_embed, daudio.SPK_WINDOW_SAMPLES, DIAR_SPK_WINDOWS,
             8000)):
        starts = rng.integers(0, len(sig) - n, count)
        w = np.stack([sig[s:s + n] for s in starts])
        lens = np.full(count, n, np.int32)
        lens[1::2] = rng.integers(lens_lo, n + 1, count // 2)  # ragged half
        for i in range(count):
            w[i, lens[i]:] = 0.0
        args_c = (torch.from_numpy(w), torch.from_numpy(lens))
        args_g = tuple(a.cuda() for a in args_c)
        t0 = time.perf_counter()
        want = net(getattr(cpu, name), *args_c).numpy()
        cpu_s = time.perf_counter() - t0
        got = net(getattr(gpu, name), *args_g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = net(getattr(gpu, name), *args_g)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = cuda_ms(lambda: net(getattr(gpu, name), *args_g),
                         launches=4, repeats=3)
        got = got.cpu().numpy()
        if name == "vad":
            err = float(np.abs(got - want).max())
            ok = err <= 1e-4
        else:
            err = float(np.abs(got - want).max()
                        / max(1.0, np.abs(want).max()))
            ok = err <= 1e-3
        log(f"[8 nets] {name} x {count} windows ({n} samples, half ragged): "
            f"card vs CPU {err:.3e} ({'ok' if ok else 'FAIL'}); card "
            f"{host_ms:.2f} ms per call on the host clock, {dev_ms:.3f} ms "
            f"device (CUDA events), {count / (dev_ms / 1e3):.0f} windows/s; "
            f"CPU {cpu_s * 1e3:.0f} ms ({card})")
        if not ok:
            bad[name] = err
        # graphed against eager through the pipeline's call of the net
        fn = "_vad_fn" if name == "vad" else "_spk_fn"
        run_g = getattr(DiarizePipeline(gpu), fn)
        run_e = getattr(DiarizePipeline(eager), fn)
        outs = [run_g(w, lens) for _ in range(3)]
        ref = run_e(w, lens)
        equal = all(np.array_equal(o, ref) for o in outs)
        ms = {"graphed": [], "eager": []}
        for i in range(6):
            form, f = (("graphed", run_g), ("eager", run_e))[(i + i // 2) % 2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f(w, lens)
            ms[form].append((time.perf_counter() - t0) * 1e3)
        key = gpu.graphs.entries[((name, count), 0)]
        log(f"[8 nets] {name} x {count} through the pipeline: graphed equal "
            f"to eager bit for bit over warm-up, capture, replay: {equal}; "
            f"host ms per call (with the upload and the host copy) graphed "
            f"{statistics.median(ms['graphed']):.2f}, eager "
            f"{statistics.median(ms['eager']):.2f}; captures {key.captures} "
            f"({key.capture_seconds:.3f} s, pool "
            f"{key.pool_bytes / 1e6:.1f} MB), replays {key.replays} ({card})")
        if not equal or key.captures != 1:
            bad[f"{name} graphed"] = (equal, key.captures)
    centers = rng.standard_normal((4, 192))
    emb = np.concatenate([c + 0.4 * rng.standard_normal((DIAR_NMESC_N // 4,
                                                          192))
                          for c in centers])
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = nmesc_cluster(emb)
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"[8 nets] NME-SC over {len(emb)} embeddings on the host CPU: "
        f"{statistics.median(times):.1f} ms (median of 3), "
        f"{res.est_num_speakers} speakers")
    if bad or res.est_num_speakers < 1:
        raise SystemExit(f"phase 8 (nets): card and CPU disagree: {bad}")


def phase_diarize_pipeline(torch, gpu, cpu, eager) -> None:
    """The same 30 s signal through DiarizePipeline on the card (graphed,
    the default) and on the CPU: segments, RTTM and speaker count equal;
    at least one segment and one embedding. And on the card eagerly
    (graphs off): segments, RTTM and every embedding bit-equal to the
    graphed run's."""
    sig = diarize_signal()
    t0 = time.perf_counter()
    pg, rg = _pipeline_run(gpu, sig)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pe, re_ = _pipeline_run(eager, sig)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pc, rc = _pipeline_run(cpu, sig)
    cpu_s = time.perf_counter() - t0
    same = (pg.segments == pc.segments and rg.rttm == rc.rttm
            and rg.n_speakers == rc.n_speakers)
    graphed_same = (pg.segments == pe.segments and rg.rttm == re_.rttm
                    and len(pg.embs) == len(pe.embs)
                    and all(np.array_equal(a, b)
                            for a, b in zip(pg.embs, pe.embs)))
    log(f"[8 pipeline] 30 s signal: card graphed {card_s:.2f} s, eager "
        f"{eager_s:.2f} s, CPU {cpu_s:.2f} s; {pg.n_segments} segments, "
        f"{pg.n_embeddings} embeddings, {rg.n_speakers} speakers, "
        f"{len(rg.rttm.splitlines())} RTTM lines; card equal to CPU: {same};"
        f" graphed equal to eager bit for bit: {graphed_same}; graphs "
        f"{json.dumps(gpu.graphs.stats())}")
    if not same or not pg.n_segments or not pg.n_embeddings \
            or not graphed_same or gpu.graphs.stats()["recaptures"]:
        raise SystemExit(f"phase 8 (pipeline): card {pg.segments} "
                         f"{rg.rttm!r} vs CPU {pc.segments} {rc.rttm!r}, "
                         f"graphed vs eager {graphed_same}")


async def _diarize_clients(srv, audios, diarize):
    """One TCP client per audio through `srv` (clients with diarize[i] set
    START with {"diarize": true}); returns (texts, OP_DIARIZE lines per
    client)."""
    from nemotron_tpu_torch.serving.client import transcribe_file

    server = await srv.start("127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    lines = [[] for _ in audios]
    try:
        texts = await asyncio.wait_for(asyncio.gather(*[
            transcribe_file(a, host="127.0.0.1", port=port, chunk_ms=200,
                            diarize=d, on_diarize=lines[i].append)
            for i, (a, d) in enumerate(zip(audios, diarize))]), timeout=300)
    finally:
        await srv.stop(server)
    return texts, lines


def phase_diarize_server(torch, model, dparams) -> dict:
    """StreamServer with a diarize model: 4 TCP clients x 6 s at R=0, two
    of them diarize streams; each diarize stream gets word frames and a
    result frame last, every text equals a plain server's; B1 L times and
    B2 at least once per chunk step. Returns the run's launch counts."""
    from nemotron_tpu_torch import kernels
    from nemotron_tpu_torch.serving.server import StreamServer

    audios = list(stream_audio(4, 6 * 16000, SEED + 8))
    diarize = [True, False, True, False]
    kernels.reset_counts()
    srv = StreamServer(model, batch_per_group=8, diarize_params=dparams)
    t0 = time.perf_counter()
    texts, lines = asyncio.run(_diarize_clients(srv, audios, diarize))
    secs = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels.KERNELS}
    steps = srv.engine.stats()["groups"][0]["chunk_steps"]
    plain, _ = asyncio.run(_diarize_clients(
        StreamServer(model, batch_per_group=8), audios, [False] * 4))
    L = model.hp.n_layers
    bad = []
    for i, d in enumerate(diarize):
        objs = [json.loads(x) for x in lines[i]]
        words = [o for o in objs if "word" in o]
        if d and not (words and objs[-1].get("type") == "result"
                      and objs[-1].get("n_speakers", 0) >= 1
                      and "error" not in objs[-1]):
            bad.append(f"client {i}: {len(words)} words, last "
                       f"{lines[i][-1:]!r:.200}")
        if not d and lines[i]:
            bad.append(f"plain client {i} got OP_DIARIZE")
        log(f"[8 server] client {i} ({'diarize' if d else 'plain'}): "
            f"{len(texts[i])} chars, equal to the plain server's: "
            f"{texts[i] == plain[i]}; {len(words)} word frames, "
            f"{'result ' + lines[i][-1][:160] if d and lines[i] else ''}")
    log(f"[8 server] 4 clients x 6 s (2 diarize), batch 8, {secs:.2f} s; "
        f"launches {counts} over {steps} chunk steps (want t1_attention "
        f"{L * steps}, mel_frames >= {steps})")
    if bad or texts != plain or not all(texts) or not steps \
            or counts["t1_attention"] != L * steps \
            or counts["mel_frames"] < steps:
        raise SystemExit(f"phase 8 (server): {bad}; texts equal "
                         f"{texts == plain}; launches {counts}")
    return counts


def expected_cli_stdout(model, dparams, audio_i16, rttm: bool,
                        as_json: bool) -> str:
    """What `transcribe_stream --diarize` prints (80 ms chunks, no
    --speaker-text): the session's text, word JSON lines as they complete
    (as_json), then the RTTM (rttm) or the speaker text, from an
    in-process StreamSession and DiarizePipeline."""
    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.diarize.pipeline import DiarizePipeline
    from nemotron_tpu_torch.streaming.session import StreamSession

    sess = StreamSession(model, CacheConfig.for_mode(0, model.hp))
    diar = DiarizePipeline(dparams)
    out = []
    for i in range(0, len(audio_i16), 1280):
        a = audio_i16[i:i + 1280]
        text = sess.process_incremental(a)
        out.append(text)
        diar.push_audio(a.astype(np.float32) / 32768.0)
        if text:
            diar.push_text(text, sess.total_audio_seconds)
        if as_json:
            out += [line + "\n" for line in diar.drain_json()]
    tail = sess.finalize()
    out.append(tail + "\n")
    if tail:
        diar.push_text(tail, sess.total_audio_seconds)
    res = diar.finalize()
    if not rttm:
        out.append(res.speaker_text + "\n")
    else:
        out.append(res.rttm)
    return "".join(out)


def phase_diarize_cli(torch, hp, dense, vocab, dparams, work) -> None:
    """`python -m nemotron_tpu_torch.cli.transcribe_stream --diarize
    --rttm --json` on the card (an F16 GGUF of the random model and the
    diarize GGUF in `work`): stdout equal to the in-process pipeline's on
    a model loaded from the same F16 GGUF."""
    from nemotron_tpu_torch.api import ASRModel
    from nemotron_tpu_torch.params import save_gguf

    gguf, pcm = work / "random_f16.gguf", work / "audio.pcm"
    save_gguf(str(gguf), hp, dense, vocab)
    audio = (diarize_signal(8) * 32767).astype(np.int16)
    pcm.write_bytes(audio.astype("<i2").tobytes())
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", CLI_RUNNER, "transcribe_stream", str(gguf),
         str(pcm), "--diarize", str(work / "diarize.gguf"), "--rttm",
         "--json"], cwd=work.parent, capture_output=True, text=True,
        timeout=600)
    secs = time.perf_counter() - t0
    model = ASRModel.from_gguf(str(gguf), device="cuda")
    want = expected_cli_stdout(model, dparams, audio, rttm=True,
                               as_json=True)
    del model
    torch.cuda.empty_cache()
    got = [ln for ln in out.stderr.splitlines()
           if ln.startswith("KERNEL_LAUNCHES ")]
    sub = json.loads(got[-1].split(" ", 1)[1]) if got else {}
    n_words = sum(ln.startswith('{"word"') for ln in want.splitlines())
    n_rttm = sum(ln.startswith("SPEAKER ") for ln in want.splitlines())
    log(f"[8 cli] transcribe_stream --diarize --rttm --json: rc "
        f"{out.returncode} in {secs:.1f} s; stdout equal to the in-process "
        f"pipeline's: {out.stdout == want} ({n_words} word lines, {n_rttm} "
        f"RTTM lines); launches {sub}")
    if out.returncode != 0 or out.stdout != want or not n_rttm \
            or not sub.get("t1_attention") or not sub.get("mel_frames"):
        raise SystemExit(f"phase 8 (cli): stdout {out.stdout[-2000:]!r}\n"
                         f"want {want[-2000:]!r}\nstderr "
                         f"{out.stderr[-2000:]}")


# Runs `n` real-time paced TCP clients (80 ms pushes) against a server in a
# process of their own, and prints their transcripts as one JSON list.
PACED_CLIENTS = """
import asyncio, json, sys
import numpy as np
from nemotron_tpu_torch.serving.client import transcribe_file
port, n, secs, seed = (int(a) for a in sys.argv[1:5])
rng = np.random.default_rng(seed)
t = np.arange(secs * 16000) / 16000.0
audios = [(np.clip(0.3 * np.sin(2 * np.pi * (180 + 7 * i) * t)
                   + 0.1 * rng.standard_normal(len(t)), -1, 1)
           * 32767).astype(np.int16) for i in range(n)]
async def main():
    return await asyncio.gather(*[
        transcribe_file(a, host="127.0.0.1", port=port, chunk_ms=80,
                        realtime=True) for a in audios])
print(json.dumps(asyncio.run(main())))
"""


def _paced(port: int, n: int, secs: int, seed: int) -> list[str]:
    out = subprocess.run(
        [sys.executable, "-c", PACED_CLIENTS, str(port), str(n), str(secs),
         str(seed)], capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise SystemExit(f"phase 8 (native): paced clients failed:\n"
                         f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _serve_stats(engine, wall: float) -> str:
    g = engine.stats()["groups"][0]
    lat = g.get("emit_latency_ms", {})
    return (f"emit p50 {lat.get('p50')} / p99 {lat.get('p99')} ms "
            f"(n {lat.get('n')}), host {1e3 * g['tick_seconds'] / max(1, g['ticks']):.3f}"
            f" ms per tick over {g['ticks']} ticks ({g['steps']} dispatches), "
            f"engine-thread idle share "
            f"{max(0.0, 1.0 - g['tick_seconds'] / wall):.3f}")


def phase_native(torch, model, card: str) -> dict:
    """The native ingest server (C++ epoll thread) against the asyncio
    server: 4 clients x 3 s at batch 8, texts equal; then NATIVE_PACED
    real-time paced clients on each (clients in a process of their own):
    emit p50 / p99, host ms per tick, engine-thread idle share. Returns the
    native run's launch counts."""
    import threading

    from nemotron_tpu_torch import kernels
    from nemotron_tpu_torch.serving.native_server import NativeStreamServer
    from nemotron_tpu_torch.serving.server import StreamServer

    def native_run(batch, clients):
        srv = NativeStreamServer(model, batch_per_group=batch)
        port = srv.start("127.0.0.1", 0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        t0 = time.perf_counter()
        try:
            texts = clients(port)
        finally:
            wall = time.perf_counter() - t0
            srv.stop()
            th.join(timeout=30)
        return texts, srv, wall

    def asyncio_run(batch, clients):
        async def run():
            srv = StreamServer(model, batch_per_group=batch)
            server = await srv.start("127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            t0 = time.perf_counter()
            try:
                texts = await asyncio.to_thread(clients, port)
            finally:
                wall = time.perf_counter() - t0
                await srv.stop(server)
            return texts, srv, wall
        return asyncio.run(run())

    audios = list(stream_audio(4, 48000, SEED + 9))

    def four(port):
        from nemotron_tpu_torch.serving.client import transcribe_file

        async def run():
            return await asyncio.gather(*[
                transcribe_file(a, host="127.0.0.1", port=port, chunk_ms=200)
                for a in audios])
        return asyncio.run(run())

    kernels.reset_counts()
    n_texts, n_srv, _ = native_run(8, four)
    counts = {k.name: k.launches for k in kernels.KERNELS}
    steps = n_srv.engine.stats()["groups"][0]["chunk_steps"]
    a_texts, _, _ = asyncio_run(8, four)
    L = model.hp.n_layers
    log(f"[8 native] 4 clients x 3 s, batch 8: texts equal to the asyncio "
        f"server's: {n_texts == a_texts} (chars {[len(t) for t in n_texts]}); "
        f"launches {counts} over {steps} chunk steps")
    if n_texts != a_texts or not all(n_texts) or not steps \
            or counts["t1_attention"] != L * steps \
            or counts["mel_frames"] < steps:
        raise SystemExit(f"phase 8 (native): texts {n_texts} vs "
                         f"{a_texts}; launches {counts}")
    for name, run in (("asyncio", asyncio_run),
                      ("native ingest", native_run)):
        texts, srv, wall = run(NATIVE_PACED, lambda port: _paced(
            port, NATIVE_PACED, NATIVE_PACED_SECS, SEED + 10))
        extra = ""
        if name == "native ingest":
            secs = srv.loop_seconds
            extra = (f"; native loop wait share "
                     f"{secs['wait'] / wall:.3f} of {wall:.2f} s")
        log(f"[8 native] {name} server, {NATIVE_PACED} real-time paced "
            f"clients x {NATIVE_PACED_SECS} s at batch {NATIVE_PACED}: "
            f"{sum(bool(t) for t in texts)} non-empty texts; "
            f"{_serve_stats(srv.engine, wall)}{extra} ({card})")
        if len(texts) != NATIVE_PACED or not any(texts):
            raise SystemExit(f"phase 8 (native): {name} paced run gave "
                             f"{len(texts)} texts")
    return counts


def phase_diarize(torch, hp, dense, vocab, model, card: str) -> dict:
    """Phase 8: the diarize nets, the pipeline, the diarize server and CLI
    on the card at the published widths with the full-width random ASR
    model (f32, R=0), then the native ingest server. Returns
    {"diarize": launches of the diarize server run, "native_server":
    those of the native server's}."""
    import shutil
    from pathlib import Path

    from nemotron_tpu_torch.diarize.params import load_diarize_model

    work = Path(__file__).resolve().parent / "_smoke"  # git-ignored
    work.mkdir(exist_ok=True)
    dpath = work / "diarize.gguf"
    try:
        t0 = time.perf_counter()
        write_random_diarize_gguf(str(dpath))
        gpu = load_diarize_model(str(dpath), device="cuda")
        eager = load_diarize_model(str(dpath), device="cuda")
        eager.graphs.enabled = False
        cpu = load_diarize_model(str(dpath), device="cpu")
        log(f"[8 diarize] random diarize GGUF (seed {DIAR_SEED}, "
            f"{dpath.stat().st_size / 1e6:.1f} MB) written and loaded in "
            f"{time.perf_counter() - t0:.1f} s")
        phase_diarize_nets(torch, gpu, cpu, eager, card)
        phase_diarize_pipeline(torch, gpu, cpu, eager)
        del eager
        launches = {"diarize": phase_diarize_server(torch, model, gpu)}
        phase_diarize_cli(torch, hp, dense, vocab, gpu, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches["native_server"] = phase_native(torch, model, card)
    return launches


# --- phase 9: multi-device serving on a mesh ---------------------------------

MESH_B = 32        # tick parity's streams
MESH_TICKS = 6     # tick parity's ticks
MESH_TIMED_B = 256  # the timed ticks' streams
MESH_SHAPES = ((1, 1), (2, 1), (2, 2))  # timed dp x tp on one card


def one_card_mesh(n_dp: int, n_tp: int):
    """A dp x tp mesh with every device cuda:0 (a one-card machine)."""
    from nemotron_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_dp, n_tp, devices=["cuda:0"] * (n_dp * n_tp))


def mesh_kernels(torch, report):
    """B1, B3 and B4 / B5 at the shapes a tp shard gives them, each against
    its plain version (not counted as the path's launches), timed with CUDA
    events beside phase 3's unsharded rows: B3 at H = 4 and 2 heads of D =
    1024 with the residual left out, f32 and bf16, dense and int8 caches;
    B4 / B5 at the four tp = 2 (N, K) (q/k/v/pos 512 x 1024, ffn w1 2048 x
    1024, ffn w2 1024 x 2048, attn out 1024 x 512; the Q4_0 nibbles
    re-packed per K slice) in f32 and bf16 at M = 256 and 256 x 14 (R=13);
    B2 once per dp=2 shard (128 x 8 and 16 x 8 frames); B1 on a
    head-sharded int8 cache (4 heads, a contiguous buffer of its own) at
    B = 256."""
    from nemotron_tpu_torch.ops import quant
    from nemotron_tpu_torch.ops.attn_block import (t1_attention_block,
                                                   t1_attention_block_ref)
    from nemotron_tpu_torch.ops.attn_kernel import (t1_attention_core,
                                                    t1_attention_core_ref)
    from nemotron_tpu_torch.params import tp_slice

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 90)
    ok = True

    def check(kname, case, got, want, tol, fn, plain, nbytes, ops, dname):
        nonlocal ok
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        good = bool(torch.isfinite(got).all()) and err <= tol
        ok &= good
        b_ms, b_by = bound(nbytes, ops, dname)
        res = dict(max_abs_err=err, ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log(f"[9 kernels] {kname} {case}: max|err| {err:.3e} (bound "
            f"{tol:.3g}) {'ok' if good else 'FAIL'}; kernel {res['ms']:.4f} "
            f"ms, plain {res['plain_ms']:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by}, share {b_ms / res['ms']:.2f})")
        report[kname].setdefault("mesh_cases", {})[case] = res

    def flat(outs):
        return torch.cat([o.float().flatten() for o in outs])

    for h_l in (4, 2):
        for int8 in (False, True):
            for dname, dtype in (("f32", torch.float32),
                                 ("bf16", torch.bfloat16)):
                a = _block_case(torch, rng, dev, dtype, int8, 256)
                hs = slice(0, h_l)
                rows = slice(0, h_l * 128)
                for w in ("q_w", "k_w", "v_w"):
                    a[w] = a[w][rows].contiguous()
                a["out_w"] = a["out_w"][:, rows].contiguous()
                for k in ("bias_u", "bias_v", "pp"):
                    a[k] = a[k][hs].contiguous()
                for k in ("k_buf", "v_buf"):
                    buf = a[k]
                    a[k] = (type(buf)(buf.q[:, hs].contiguous(),
                                      buf.s[:, hs].contiguous()) if int8
                            else buf[:, hs].contiguous())
                a["n_heads"] = h_l
                want = t1_attention_block_ref(**a, residual=False)
                ins = [v for v in a.values() if not isinstance(v, int)]
                e, d, s = h_l * 128, 1024, 78
                check("t1_attention_block",
                      f"tp heads H={h_l} D=1024 residual off, "
                      f"{'int8' if int8 else 'dense'} caches, {dname} B=256",
                      flat(t1_attention_block(**a, residual=False)),
                      flat(want), GEMM_REL[dname] * float(
                          flat(want).abs().max()),
                      lambda a=a: t1_attention_block(**a, residual=False),
                      lambda a=a: t1_attention_block_ref(**a,
                                                         residual=False),
                      tensor_bytes(*ins, *want),
                      2.0 * 256 * d * 4 * e + 6.0 * 256 * h_l * (s + 1)
                      * 128, dname)

    for bits, kname in ((8, "q8_matmul"), (4, "q4_matmul")):
        qz = quant.quantize_q8 if bits == 8 else quant.quantize_q4
        fn, ref = ((quant.linear_q8, quant.linear_q8_ref) if bits == 8
                   else (quant.linear_q4, quant.linear_q4_ref))
        for full_n, full_k, axis in ((1024, 1024, 1), (4096, 1024, 1),
                                     (1024, 4096, 2), (1024, 1024, 2)):
            w = (rng.standard_normal((1, full_n, full_k)) / np.sqrt(full_k)
                 ).astype(np.float32)
            qt = tp_slice(qz(w), axis, 2, 1)[0].to(dev)
            codes = qt.w_i8 if bits == 8 else qt.w_packed
            n = qt.scales.shape[0]
            k = qt.scales.shape[1] * quant.QBLOCK
            for dname, dtype in (("f32", torch.float32),
                                 ("bf16", torch.bfloat16)):
                for m in (256, 256 * 14):
                    x = torch.tensor(rng.standard_normal((m, k)).astype(
                        np.float32), device=dev).to(dtype)
                    want = ref(x, qt)
                    check(kname, f"tp=2 {dname} M={m} N={n} K={k}",
                          fn(x, qt), want,
                          GEMM_REL[dname] * float(want.abs().max()),
                          lambda x=x, qt=qt: fn(x, qt),
                          lambda x=x, qt=qt: ref(x, qt),
                          tensor_bytes(codes, qt.scales, x, want),
                          2.0 * m * n * k, dname)

    # B2 once per dp shard: B/2 streams of a B = 256 and a B = 32 tick at
    # dp=2, dense filterbank (phase 3's rule: within 1e-3 of the plain
    # version, 1e-4 of the exact float64 log-mel; the same bound)
    from nemotron_tpu_torch.ops.mel import padded_window
    from nemotron_tpu_torch.ops.mel_kernel import mel_frames, mel_frames_ref
    from nemotron_tpu_torch.tools.gemm_turns import mel_exact

    win = padded_window(torch.tensor(np.hanning(400).astype(np.float32),
                                     device=dev))
    fb = torch.tensor(rng.uniform(0, 1, (128, 257)).astype(np.float32),
                      device=dev)
    for b in (128, 16):
        buf = torch.tensor((rng.standard_normal((b, 7 * 160 + 512)) * 0.1
                            ).astype(np.float32), device=dev)
        want = mel_frames_ref(buf, win, fb, 8)
        got = mel_frames(buf, win, fb, 8)
        x_err = float((got - mel_exact(torch, buf, win, fb, 8)).abs().max())
        ok &= x_err <= 1e-4
        nnz = int((fb != 0).sum())
        check("mel_frames", f"dp shard B={b} x 8 dense mels=128 (exact "
              f"{x_err:.3e})", got, want, 1e-3,
              lambda buf=buf: mel_frames(buf, win, fb, 8),
              lambda buf=buf: mel_frames_ref(buf, win, fb, 8),
              tensor_bytes(buf, win, want) + 4 * nnz,
              b * 8 * (512 + 2.5 * 512 * 9 + 3.0 * 257 + 2.0 * nnz + 128),
              "f32")

    for dname, dtype, atol in (("f32", torch.float32, 2e-5),
                               ("bf16", torch.bfloat16, 2e-2)):
        q, kn, vn, pm, kb, vb = _attn_case(torch, rng, dev, dtype, True, 256)
        hs = slice(4, 8)  # tp shard 1's heads, a buffer of their own
        args = [q[:, hs].contiguous(), kn[:, hs].contiguous(),
                vn[:, hs].contiguous(), pm[:, hs].contiguous()]
        args += [type(b)(b.q[:, hs].contiguous(), b.s[:, hs].contiguous())
                 for b in (kb, vb)]
        check("t1_attention", f"tp head shard H=4 of 8, int8 caches, {dname} "
              "B=256 S_buf=78 Dh=128", t1_attention_core(*args),
              t1_attention_core_ref(*args), atol,
              lambda: t1_attention_core(*args),
              lambda: t1_attention_core_ref(*args),
              tensor_bytes(*args) + tensor_bytes(args[0]),
              4.0 * 256 * 4 * 79 * 128, dname)
    if not ok:
        raise SystemExit("phase 9: a kernel disagrees with its plain version "
                         "at a tp shard's shapes")


def logical(model, state) -> dict:
    """A stream state's logical leaves by name, on the CPU: K/V as f32
    values (int8 ones dequantized, their codes as `<name>.q`), the rest as
    they are; the same for a single device's state and a mesh's."""
    from nemotron_tpu_torch.ops.kvquant import dequantize_kv, is_quant
    from nemotron_tpu_torch.streaming.state import (state_from_leaves,
                                                    state_leaves)

    s = state_from_leaves([x.detach().cpu() for x in state_leaves(state)],
                          model.kv_int8)
    out = {}
    for n in ("k_cache", "v_cache"):
        buf = getattr(s, n)
        out[n] = dequantize_kv(buf) if is_quant(buf) else buf.float()
        if is_quant(buf):
            out[n + ".q"] = buf.q
    out["conv_cache"] = s.conv_cache.float()
    out["decode.h"], out["decode.c"] = s.decode.h.float(), s.decode.c.float()
    for n in ("cache_valid", "pp_tail", "pp_last", "mel_ov"):
        out[n] = getattr(s, n)
    out["decode.prev_token"] = s.decode.prev_token
    out["decode.frame_offset"] = s.decode.frame_offset
    return out


class MeshCounts:
    """The kernels' launches on the mesh's own runs, summed: a `with` block
    adds the launches made inside it (the single-device references and the
    kernel checks stay outside)."""

    def __init__(self):
        from nemotron_tpu_torch import kernels

        self.kernels = kernels
        self.total = {k.name: 0 for k in kernels.KERNELS}

    def __enter__(self):
        self.kernels.reset_counts()
        return self

    def __exit__(self, *exc):
        for k in self.kernels.KERNELS:
            self.total[k.name] += k.launches
        self.last = {k.name: k.launches for k in self.kernels.KERNELS}
        self.kernels.reset_counts()
        return False


def mesh_tick_parity(torch, counts, name, single, mesh_model, ref=None,
                     mode=0):
    """MESH_TICKS all-active fused ticks over MESH_B streams on the mesh
    model and on the single-device one (run_ticks: a k = n_phases tick
    first past R=0). f32 (`ref` None): tokens equal, float leaves within
    1e-4, integer leaves equal. Otherwise (bf16, quantized weights, int8
    K/V), PERF.md section 2's rule against `ref`, the single device's f32
    dense run: the token-independent caches (K, V dequantized, conv)
    within BF16_VS_REF x their own error max|single - ref|, int8 codes
    within +-1 under f32 activations (bf16's drift moves codes further,
    held through the dequantized K/V), cache_valid equal, and token cells differing at most
    BF16_VS_REF x those differing between single and ref. Returns the
    single device's (logical leaves, tokens), the reference of later
    calls."""
    audio = stream_audio(MESH_B, 96 + sum(tick_chunks(mode, MESH_TICKS))
                         * single.cache_config(mode).shift_samples, SEED + 91)
    s1, t1 = run_ticks(single, audio, MESH_TICKS, mode)
    with counts:
        s2, t2 = run_ticks(mesh_model, audio, MESH_TICKS, mode)
        torch.cuda.synchronize()
    a, b = logical(single, s1), logical(mesh_model, s2)
    errs = {n: float((b[n].float() - a[n].float()).abs().max()) for n in a}
    bad, own = [], {}
    n_diff = int((t1 != t2).sum())
    if ref is None:
        bad += [n for n, e in errs.items() if e > 1e-4]
        if n_diff:
            bad.append(f"{n_diff} token cells differ")
        rule = "f32: tokens equal, leaves within 1e-4"
    else:
        r, r_tok = ref
        for n in ("k_cache", "v_cache", "conv_cache"):
            own[n] = float((a[n] - r[n]).abs().max())
            if not errs[n] <= BF16_VS_REF * own[n]:
                bad.append(f"{n} {errs[n]:.3e} > {BF16_VS_REF:g} x "
                           f"{own[n]:.3e}")
        for n in ("k_cache.q", "v_cache.q"):  # f32 activations only: int8
            # amplifies bf16's drift by 127 / amax (ROADMAP fault F1)
            if n in errs and errs[n] > 1 and \
                    single.params.pos_emb.dtype == torch.float32:
                bad.append(f"{n} codes differ by {errs[n]:g}")
        if errs["cache_valid"]:
            bad.append("cache_valid differs")
        n_own = int((t1 != r_tok).sum())
        if n_diff > BF16_VS_REF * n_own:
            bad.append(f"{n_diff} token cells differ, > {BF16_VS_REF:g} x "
                       f"{n_own}")
        rule = (f"K/V/conv within {BF16_VS_REF:g} x own {fmt(own)}, token "
                f"cells differing <= {BF16_VS_REF:g} x own {n_own}")
    steps = sum(tick_chunks(mode, MESH_TICKS))
    log(f"[9 tick] {name} R={mode} {mesh_model.backend_name} vs one device, "
        f"B={MESH_B} x {len(tick_chunks(mode, MESH_TICKS))} ticks: max|diff| "
        f"{fmt(errs)}; token cells differing {n_diff} of {t1.size} "
        f"({int((t2 >= 0).sum())} emitted); rule: {rule}; launches "
        f"{json.dumps(counts.last)} over {steps} chunk steps: "
        f"{ {k: v / steps for k, v in counts.last.items()} }")
    if bad:
        raise SystemExit(f"phase 9 (tick {name}): mesh and one device "
                         f"disagree: {bad}")
    return a, t1


def mesh_servers(torch, counts, single, mesh2x2, mesh_dp2):
    """The asyncio server on the 2x2 mesh and the native server on the dp=2
    mesh, 4 clients x 3 s at batch 8: texts equal to the single-device
    asyncio server's; launch counts per chunk step."""
    from nemotron_tpu_torch.serving.native_server import NativeStreamServer

    audios = list(stream_audio(4, 48000, SEED + 92))
    want, _ = asyncio.run(_serve_clients(single, audios, 8, (0,) * 4))
    with counts:
        got, stats = asyncio.run(_serve_clients(mesh2x2, audios, 8,
                                                (0,) * 4))
    steps = stats["groups"][0]["chunk_steps"]
    log(f"[9 server] StreamServer on {mesh2x2.backend_name}, 4 clients x 3 "
        f"s at batch 8: texts equal to one device's: {got == want} (chars "
        f"{[len(t) for t in got]}); launches per chunk step "
        f"{ {k: v / max(steps, 1) for k, v in counts.last.items()} } over "
        f"{steps} steps")
    if got != want or not any(want):
        raise SystemExit(f"phase 9 (server): {got} vs {want}")

    import threading

    srv = NativeStreamServer(mesh_dp2, batch_per_group=8)
    with counts:
        port = srv.start("127.0.0.1", 0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            from nemotron_tpu_torch.serving.client import transcribe_file

            async def run():
                return await asyncio.gather(*[
                    transcribe_file(a, host="127.0.0.1", port=port,
                                    chunk_ms=200) for a in audios])
            got = asyncio.run(run())
        finally:
            srv.stop()
            th.join(timeout=30)
    steps = srv.engine.stats()["groups"][0]["chunk_steps"]
    log(f"[9 native] native server on {mesh_dp2.backend_name}, 4 clients x "
        f"3 s at batch 8: texts equal to one device's asyncio server's: "
        f"{got == want}; launches per chunk step "
        f"{ {k: v / max(steps, 1) for k, v in counts.last.items()} }")
    if got != want:
        raise SystemExit(f"phase 9 (native): {got} vs {want}")
    return want, audios


def mesh_migrate(torch, counts, single, mesh_dp2):
    """A stream exported mid-flight from a dp=2 engine (batch 8, its slot in
    shard 1) through the snapshot bytes into a single-device engine: its
    text equals an unmigrated single-device engine's."""
    from nemotron_tpu_torch.streaming.engine import (BatchedEngine,
                                                     snapshot_from_bytes,
                                                     snapshot_to_bytes)

    audio = stream_audio(1, 48000, SEED + 93)[0]
    push = 1600

    def run(engine, lo, hi, sid, text=""):
        for off in range(lo, hi, push):
            engine.push_audio(sid, audio[off:off + push])
            text += "".join(e.text for e in engine.tick()[0]
                            if e.stream_id == sid)
        return text

    def drain(engine, sid, text):
        engine.end_stream(sid)
        for _ in range(200):
            events, more = engine.tick()
            text += "".join(e.text for e in events if e.stream_id == sid)
            if not more:
                return text
        raise SystemExit("phase 9 (migrate): an engine did not go idle")

    plain = BatchedEngine(single, batch_per_group=1)
    sid = plain.start_stream(0)
    want = drain(plain, sid, run(plain, 0, len(audio), sid))
    cut = 24000
    with counts:
        eng = BatchedEngine(mesh_dp2, batch_per_group=8)
        decoys = [eng.start_stream(0) for _ in range(4)]  # shard 0's slots
        sid = eng.start_stream(0)
        text = run(eng, 0, cut, sid)
        fut = eng.request_export(sid)
        text += "".join(e.text for e in eng.tick()[0] if e.stream_id == sid)
        blob = snapshot_to_bytes(fut.result(timeout=60))
        for d in decoys:
            eng.end_stream(d)
        del eng
    dst = BatchedEngine(single, batch_per_group=8)
    fut = dst.request_import(snapshot_from_bytes(blob, single))
    dst.tick()
    sid2 = fut.result(timeout=60)
    text = drain(dst, sid2, run(dst, cut, len(audio), sid2, text))
    log(f"[9 migrate] a stream exported from {mesh_dp2.backend_name} (slot "
        f"4, shard 1) at {cut / 16000:.1f} s, {len(blob)} snapshot bytes, "
        f"into a single-device engine: text equal to never moving: "
        f"{text == want} ({len(want)} chars)")
    if text != want or not want:
        raise SystemExit(f"phase 9 (migrate): {text!r} vs {want!r}")


REPLICAS = 4


def mesh_replicas(torch, single, audios):
    """ReplicaSet of REPLICAS of the port's servers ('random', seed 0, the
    blank bias, each with CUDA_VISIBLE_DEVICES=0) and a RoutedClient with
    one stream per replica (the least-loaded pick): each text equal to a
    single-device StreamSession's. A stream alone on a fresh replica joins
    at ring phase 0 and never pauses behind another stream, so its ticks
    are a session's; two streams on one live server are not (trap "live
    server texts")."""
    import socket

    from nemotron_tpu_torch.serving.replicas import ReplicaSet, RoutedClient
    from nemotron_tpu_torch.streaming.session import StreamSession

    want = []
    for a in audios:
        s = StreamSession(single, 0)
        s.process_incremental(a)
        s.finalize()
        want.append(s.get_transcript())
    for base in range(23000, 40000, 97):  # free consecutive ports
        try:
            for p in range(base, base + REPLICAS):
                with socket.socket() as sk:
                    sk.bind(("127.0.0.1", p))
            break
        except OSError:
            continue
    t0 = time.perf_counter()
    rs = ReplicaSet("random", REPLICAS, port_base=base, batch_per_group=8,
                    extra_args=["--blank-bias", str(BLANK_BIAS)],
                    env_per_replica=[{"CUDA_VISIBLE_DEVICES": "0"}]
                    * REPLICAS)
    try:
        rs.wait_ready(timeout=300)
        t_ready = time.perf_counter() - t0

        async def run():
            rc = await RoutedClient.connect(rs.addrs)
            handles = [await rc.start_stream(0) for _ in audios]
            live = list(rc.live)
            texts = await asyncio.gather(*(
                rc.transcribe(h, a, chunk_ms=200)
                for h, a in zip(handles, audios)))
            rc.close()
            return live, texts
        live, got = asyncio.run(asyncio.wait_for(run(), timeout=300))
    finally:
        rs.close()
    log(f"[9 replicas] {REPLICAS} replicas of nemotron_tpu_torch.serving."
        f"server on cuda:0 (ready in {t_ready:.1f} s), RoutedClient with "
        f"{len(audios)} streams: split {live}; texts equal to a session's: "
        f"{got == want} (chars {[len(t) for t in got]})")
    if live != [1] * REPLICAS or got != want or not any(want):
        raise SystemExit(f"phase 9 (replicas): split {live}; {got} vs "
                         f"{want}")


def mesh_times(torch, gpu, hp, vocab, card):
    """Host ms per all-active graphed tick at B=256, R=0, f32 for dp x
    tp = 1x1, 2x1 and 2x2 with every device cuda:0 (the eager rows were
    cut for the smoke's time: PERF.md section 5 keeps them), the device's
    busy time (the union of its kernels' spans: a tp group's rank streams
    overlap) and idle share of each and its kernels per tick (profiler), and
    the tp reduction's device ms per tick (the adds of the shards'
    partials: 3 per layer per dp shard, timed alone). One card: these
    show the mesh's overhead, not its scaling. Returns the rows."""
    from nemotron_tpu_torch.api import ASRModel
    from nemotron_tpu_torch.ops.basic import tp_sum

    rows = []
    for n_dp, n_tp in MESH_SHAPES:
        model = ASRModel(hp, gpu["f32"].params, vocab, device="cuda")
        if n_dp * n_tp > 1:
            model.shard(one_card_mesh(n_dp, n_tp))
        ms, prof = tick_row(torch, model, MESH_TIMED_B, 0, 12, 4)
        # every device is cuda:0: one card's busy time
        busy = sum(prof[2].values()) if prof else float("nan")
        kernel_ms = prof[0] if prof else float("nan")
        kern = round(sum(r[2] for r in prof[1])) if prof else None
        rows.append({"dp": n_dp, "tp": n_tp, "ms": round(ms, 2),
                     "busy_ms": round(busy, 2),
                     "kernel_ms": round(kernel_ms, 2),
                     "idle": round(1 - busy / ms, 3), "kernels": kern})
        log(f"[9 times] dp={n_dp} x tp={n_tp} on one card, "
            f"B={MESH_TIMED_B} R=0 f32 graphed: {ms:.2f} ms per tick (host, "
            f"median of 12), device busy {busy:.2f} ms (the union of the "
            f"kernels' spans; their times summed {kernel_ms:.2f} ms), busy "
            f"share {busy / ms:.3f}, idle share {1 - busy / ms:.3f}, "
            f"{kern} kernels per tick ({card}; one card: the mesh's "
            f"overhead, not its scaling)")
        del model
        torch.cuda.empty_cache()
        if n_tp > 1:
            b = MESH_TIMED_B // n_dp
            parts = [torch.randn((b, 1, hp.d_model), device="cuda")
                     for _ in range(n_tp)]
            one = cuda_ms(lambda: tp_sum(parts, parts[0].device))
            log(f"[9 times] dp={n_dp} x tp={n_tp}: tp reduction "
                f"{one * 3 * hp.n_layers * n_dp:.4f} ms of device per tick "
                f"({one:.5f} ms per sum of {n_tp} [{b}, 1, {hp.d_model}] "
                f"f32 parts x 3 x {hp.n_layers} layers x {n_dp} dp shards)")
    return rows


MESH_GRAPH_B = 32  # the graphed-against-eager schedule's streams on a mesh
MESH_OFFLINE_SAMPLES = 96000  # the mesh's offline file: 6 s


def mixed_q8_block(gpu, hp, vocab):
    """bf16 Q8_0 encoder matrices with the four attention matrices that
    kernel B3 reads (encoder.ATTN_BLOCK_WEIGHTS) dense, int8 K/V and
    attn_block: a model whose tp ticks launch B3 and B4 both."""
    from nemotron_tpu_torch.api import ASRModel
    from nemotron_tpu_torch.models.encoder import ATTN_BLOCK_WEIGHTS

    q8 = gpu["bf16 Q8_0 int8-KV"].params
    dense = gpu["bf16"].params.layers
    params = dataclasses.replace(q8, layers=dataclasses.replace(
        q8.layers, **{n: getattr(dense, n) for n in ATTN_BLOCK_WEIGHTS}))
    return ASRModel(hp, params, vocab, device="cuda", kv_int8=True,
                    attn_block=True)


def mesh_offline(torch, model):
    """The offline path on `model`'s mesh, one 6 s file at OFFLINE_BIAS
    (dp shard 0's tp group in the encoder's graph, a branch per rank
    stream; the decode blocks and their carry on its lead): the file's
    keys warmed up and captured, then offline_parity against an eager
    twin on the same mesh: ids, frames and the final decoder state bit
    for bit, every key of the parity call replayed, the encoder key
    captured once with the group's devices."""
    from nemotron_tpu_torch.audio.frontend import process_many
    from nemotron_tpu_torch.tools.graph_turns import twin

    graphed = offline_model(model, OFFLINE_BIAS).shard(model.mesh)
    eager = twin(graphed)
    audio = stream_audio(1, MESH_OFFLINE_SAMPLES, SEED + 92)[0]
    mels = process_many([graphed._preprocessor()], [audio])
    for _ in range(2):  # the warm-up, then the capture
        graphed._transcribe_mels(mels, None)
    same, _, secs = offline_parity(torch, graphed, eager, mels)
    segs = graphed.offline_stats
    enc = [e for (k, _), e in graphed.graphs.entries.items()
           if k[0] == "batch"]
    replayed = all(how["replays"] == how["calls"] for seg in segs
                   for how in seg["graphs"].values())
    group = tuple(graphed.groups[0].devices)
    ok = (same["ids_equal"] and same["state_equal"] and same["tokens"]
          and replayed and len(enc) == 1 and enc[0].captures == 1
          and enc[0].devices == group)
    log(f"[9 offline] {graphed.backend_name} 6 s file, blank bias "
        f"{OFFLINE_BIAS:g}, graphed against eager: {same}; host s replay "
        f"{secs[0]:.3f}, eager {secs[1]:.3f}; the replaying call's keys "
        f"{[seg['graphs'] for seg in segs]}; graphs "
        f"{json.dumps(offline_graphs(graphed))}")
    if not ok:
        raise SystemExit(f"phase 9 (offline): graphed and eager differ on "
                         f"{graphed.backend_name}: {same}, keys {segs}")
    graphed.drop_offline_graphs()
    del graphed, eager
    torch.cuda.empty_cache()


def mesh_graphs(torch, counts, gpu, hp, vocab, mesh22, step):
    """A tp group's calls as CUDA graphs at full width (the 2x2 mesh on
    cuda:0): graph_parity's schedule at MESH_GRAPH_B streams in f32 dense
    (B1, B2, kv_rows) and bf16 Q8_0 int8-K/V with the block (B3, B4;
    mixed_q8_block), then the offline path (mesh_offline). The replays'
    launches go to `counts`; B1, B3 and B4 must be among them. step(name)
    logs each part's seconds."""
    totals: dict = {}
    graph_parity(torch, "f32", mesh22, 0, totals, batch=MESH_GRAPH_B,
                 tag="9")
    step("tp graphs f32")
    block = mixed_q8_block(gpu, hp, vocab).shard(mesh22.mesh)
    graph_parity(torch, "bf16 Q8_0 int8-KV block", block, 0, totals,
                 batch=MESH_GRAPH_B, tag="9")
    del block
    step("tp graphs bf16 Q8_0 int8-KV block")
    missing = [k for k in ("t1_attention", "t1_attention_block",
                           "q8_matmul", "mel_frames", "kv_rows")
               if not totals.get(k)]
    if missing:
        raise SystemExit(f"phase 9: kernels {missing} never launched "
                         f"through a tp graph's replay")
    mesh_offline(torch, mesh22)
    step("tp offline")
    for k, v in totals.items():
        counts.total[k] += v
    torch.cuda.empty_cache()


def mesh_two_cards(torch, counts, single, card) -> list:
    """The mesh across two cards (a machine with two or more): dp (2x1)
    and tp (1x2) tick parity against `single` (one device, f32 dense);
    the 1x2 tp graphs against eager (graph_parity's schedule at
    MESH_GRAPH_B: peer copies as graph nodes, the second card's graph
    pool) and its offline path (mesh_offline); host ms per B=256 R=0 f32
    tick at 2x1 and 1x2, eager and graphed in turns, kernel ms summed,
    each card's busy ms (the union of its kernels' spans), kernels, pool
    MB. Returns the timed rows."""
    from nemotron_tpu_torch.api import ASRModel
    from nemotron_tpu_torch.parallel.mesh import make_mesh

    def on(shape, graphs=True):
        return ASRModel(single.hp, single.params, single.tokenizer.vocab,
                        device="cuda", graphs=graphs).shard(make_mesh(*shape))

    for shape in ((2, 1), (1, 2)):
        mesh_tick_parity(torch, counts, "f32 dense, two cards", single,
                         on(shape))
    totals: dict = {}
    graph_parity(torch, "f32 two cards", on((1, 2)), 0, totals,
                 batch=MESH_GRAPH_B, tag="9")
    for k, v in totals.items():
        counts.total[k] += v
    mesh_offline(torch, on((1, 2)))
    rows = []
    for shape in ((2, 1), (1, 2)):
        for graphs in (False, True):
            m = on(shape, graphs)
            ms, prof = tick_row(torch, m, MESH_TIMED_B, 0, 12, 4)
            rows.append({"mesh": m.backend_name, "graphed": graphs,
                         "ms": round(ms, 2),
                         "kernel_ms": round(prof[0], 2) if prof else None,
                         "busy_ms_by_card": {d: round(v, 2) for d, v in
                                             prof[2].items()}
                         if prof else None,
                         "kernels": round(sum(r[2] for r in prof[1]))
                         if prof else None,
                         "pool_MB": round(m.graphs.stats()["pool_bytes"]
                                          / 2 ** 20, 1)})
            log(f"[9 two cards] B={MESH_TIMED_B} R=0 f32: "
                f"{json.dumps(rows[-1])} ({card})")
            del m
            torch.cuda.empty_cache()
    return rows


def phase_mesh(torch, hp, vocab, gpu, card, report) -> dict:
    """Phase 9: the mesh at full width on the card (every device cuda:0;
    across two cards too where there are two), its tp group's calls as
    CUDA graphs (mesh_graphs). Returns the launches of the mesh's own
    runs."""
    from nemotron_tpu_torch.api import ASRModel

    t_step = [time.perf_counter()]

    def step(done: str) -> None:  # each part's seconds, for the budget
        now = time.perf_counter()
        log(f"[9 time] {done} in {now - t_step[0]:.0f} s")
        t_step[0] = now

    mesh_kernels(torch, report)
    step("kernels")
    counts = MeshCounts()

    def pair(params, mesh_shape, **kw):
        """(one device, the same weights on a one-card mesh)"""
        return (ASRModel(hp, params, vocab, device="cuda", **kw),
                ASRModel(hp, params, vocab, device="cuda", **kw).shard(
                    one_card_mesh(*mesh_shape)))

    f32 = gpu["f32"].params
    bf16 = gpu["bf16"].params
    single, mesh22 = pair(f32, (2, 2))
    ref = mesh_tick_parity(torch, counts, "f32 dense", single, mesh22)
    for name, params, kw in (
            ("bf16 block", bf16, dict(attn_block=True)),
            ("bf16 Q8_0 int8-KV", gpu["bf16 Q8_0 int8-KV"].params,
             dict(kv_int8=True)),
            ("bf16 Q4_0", gpu["bf16 Q4_0"].params, {})):
        mesh_tick_parity(torch, counts, name, *pair(params, (2, 2), **kw),
                         ref=ref)
    del ref
    mesh_tick_parity(torch, counts, "f32 dense", single,
                     ASRModel(hp, f32, vocab, device="cuda").shard(
                         one_card_mesh(2, 1)), mode=13)
    step("tick parity")
    if torch.cuda.device_count() >= 2:  # dp and tp across two cards
        mesh_two_cards(torch, counts, single, card)
        step("two cards")
    mesh_dp2 = ASRModel(hp, f32, vocab, device="cuda").shard(
        one_card_mesh(2, 1))
    _, audios = mesh_servers(torch, counts, single, mesh22, mesh_dp2)
    step("servers")
    mesh_migrate(torch, counts, single, mesh_dp2)
    step("migration")
    mesh_replicas(torch, single, audios)
    step("replicas")
    mesh_graphs(torch, counts, gpu, hp, vocab, mesh22, step)
    log(f"[9 times] {json.dumps(mesh_times(torch, gpu, hp, vocab, card))}")
    step("times")
    log(f"[9 launches] the mesh's runs: {json.dumps(counts.total)}")
    missing = [k for k, v in counts.total.items() if not v]
    if missing:
        raise SystemExit(f"phase 9: kernels {missing} never launched on the "
                         f"mesh's path")
    return counts.total


def phase_mesh_alone(two_cards: bool = False) -> int:
    """Phase 9 by itself on the card: the kernels' build, phase 9's models
    (as main() makes them) and phase_mesh, ~4-5 minutes:
    python3 -c "import sys, chip_smoke; sys.exit(chip_smoke.phase_mesh_alone())"
    With two_cards, its cross-card part alone (mesh_two_cards; a machine
    with two cards or more, e.g. a host of four H100s), ~3 minutes."""
    import torch

    from nemotron_tpu_torch import Hparams, kernels
    from nemotron_tpu_torch.api import ASRModel
    from nemotron_tpu_torch.params import params_to, quantize_encoder_layers

    t0 = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    kernels.library()
    cpu = ASRModel.random(Hparams(), seed=SEED, device="cpu")
    cpu.params.joint.out_b[cpu.hp.blank_id] += BLANK_BIAS
    hp, vocab, dense = cpu.hp, cpu.tokenizer.vocab, cpu.params
    bf16 = torch.bfloat16

    def model(params, dtype=None, **kw):
        return ASRModel(hp, params_to(params, "cuda", dtype), vocab,
                        device="cuda", **kw)

    if two_cards:
        counts = MeshCounts()
        mesh_two_cards(torch, counts, model(dense), card)
        counts = counts.total
    else:
        gpu = {"f32": model(dense), "bf16": model(dense, bf16),
               "bf16 Q8_0 int8-KV": model(quantize_encoder_layers(dense, 8),
                                          bf16, kv_int8=True),
               "bf16 Q4_0": model(quantize_encoder_layers(dense, 4), bf16)}
        report = {k.name: {} for k in kernels.KERNELS}
        counts = phase_mesh(torch, hp, vocab, gpu, card, report)
    log(f"[time] phase 9 alone after {time.perf_counter() - t0:.0f} s; "
        f"launches {json.dumps(counts)}")
    return 0


# --- phase 10: the compiled tick (CUDA graphs) -------------------------------

GRAPH_B = 256  # the parity schedule's streams
# (model, right context) of the graphed-against-eager parity schedule
GRAPH_PARITY = (("f32", 0), ("bf16 block", 0), ("bf16 int8-KV", 0),
                ("bf16 Q8_0 int8-KV", 0), ("bf16 Q4_0", 0),
                ("bf16 int8-KV", 13))
GRAPH_F32_ATOL = 1e-6  # f32 graphed vs eager where not bit-equal


def graph_parity(torch, name, model, mode, totals: dict, batch=GRAPH_B,
                 tag: str = "10") -> dict:
    """tools/graph_turns.run_schedule at `batch` streams on an eager twin,
    then on a graphed twin (its last pass's replays under
    set_sync_debug_mode("error")); on a mesh, twins on the same mesh (each
    key then one graph per dp shard, a tp group's with a branch per rank
    stream): tokens equal, every leaf bit-equal (f32: within
    GRAPH_F32_ATOL), one capture per key and dp shard and none again, and
    the kernels' launches through the replays equal to eager's (added to
    `totals`). `tag` names the phase in the log."""
    from nemotron_tpu_torch import kernels
    from nemotron_tpu_torch.tools.graph_turns import (compare, run_schedule,
                                                      twin)

    runs = {}
    for form, m in (("eager", twin(model)),
                    ("graphed", twin(model, graphs=True))):
        kernels.reset_counts()
        t0 = time.perf_counter()
        toks, state = run_schedule(m, batch, mode,
                                   sync_debug=form == "graphed")
        runs[form] = (toks, state, kernel_counts(),
                      time.perf_counter() - t0, m.graphs.stats())
        del m
    (tok_e, st_e, n_e, s_e, _), (tok_g, st_g, n_g, s_g, gs) = \
        runs["eager"], runs["graphed"]
    cmp = compare(st_g, st_e)
    n_bad = sum(not np.array_equal(g, e) for g, e in zip(tok_g, tok_e))
    f32 = not name.startswith("bf16")
    where = "" if model.mesh is None else f"{model.backend_name} "
    log(f"[{tag} parity] {name} {where}B={batch} R={mode}: "
        f"{len(tok_g)} ticks (3 "
        f"passes: warm-up, capture, replay); tokens differ on {n_bad} "
        f"ticks ({sum(int((t >= 0).sum()) for t in tok_g)} emitted); "
        f"leaves {cmp}; graphs {json.dumps(gs)}; launches graphed "
        f"{json.dumps(n_g)} eager {json.dumps(n_e)}; host s eager "
        f"{s_e:.2f} graphed {s_g:.2f} (incl. warm-ups and captures)")
    bad = []
    if n_bad:
        bad.append(f"tokens differ on {n_bad} ticks")
    if not (cmp["equal"] or (f32 and cmp["max_abs"] <= GRAPH_F32_ATOL)):
        bad.append(f"leaves {cmp}")
    if gs["captures"] != gs["keys"] or gs["recaptures"]:
        bad.append(f"captures {gs}")
    if n_g != n_e:
        bad.append(f"launches {n_g} vs {n_e}")
    if bad:
        raise SystemExit(f"phase {tag} ({name} R={mode}): graphed and "
                         f"eager differ: {bad}")
    for k, v in n_g.items():
        totals[k] = totals.get(k, 0) + v
    del runs, st_e, st_g
    torch.cuda.empty_cache()
    return {"ticks": len(tok_g), **gs}


CHURN_TICKS = (64, 64)  # the churn's ticks: warm-up, then under the check


def graph_churn(torch, model, name) -> dict:
    """tools/graph_turns.Churn at B=GRAPH_B, R=0 (joins into freed slots,
    a quarter of the streams pausing 1-7 ticks and resuming at deltas of
    1-7, wraps with paused slots, backlog ticks of 8 chunks) on an eager
    and a graphed twin in lockstep (the schedule follows the engine's own
    flow, so both run the same ticks): texts equal, final state leaves
    bit-equal, each slot operation's key (prime, reset, compact, realign)
    captured once (in the engine's prewarm) and replayed after, and the
    graphed engine's slot operations of the last CHURN_TICKS[1] ticks
    under set_sync_debug_mode("error")."""
    import contextlib

    from nemotron_tpu_torch.tools.graph_turns import (SLOT_KEYS, Churn,
                                                      compare,
                                                      slot_ops_sync_errors,
                                                      twin)

    runs = {}
    for form, m in (("eager", twin(model)), ("graphed", twin(model, True))):
        t0 = time.perf_counter()
        ch = Churn(m, GRAPH_B, 0)
        ch.run(CHURN_TICKS[0])
        with (slot_ops_sync_errors(m) if form == "graphed"
              else contextlib.nullcontext()):
            ch.run(CHURN_TICKS[1])
        torch.cuda.synchronize()
        runs[form] = (ch, time.perf_counter() - t0)
    (ch_e, s_e), (ch_g, s_g) = runs["eager"], runs["graphed"]
    cmp = compare(ch_g.group.state, ch_e.group.state)
    slot = {" ".join(map(str, key[:1] + key[2:])): (e.calls, e.captures,
                                                    e.replays)
            for (key, _), e in ch_g.model.graphs.entries.items()
            if key[0] in SLOT_KEYS}
    # the warm-up call eager, the capturing call and every later one
    # replays
    once = all(c == 1 and r == n - 1 for n, c, r in slot.values())
    kinds = {key.split()[0] for key, (n, _, _) in slot.items() if n > 2}
    texts_equal = ch_e.texts == ch_g.texts
    log(f"[10 churn] {name} B={GRAPH_B} R=0: {ch_g.t} ticks, "
        f"{ch_g.group.total_steps} dispatches, "
        f"{ch_g.group.total_chunk_steps - ch_g.group.total_steps} backlog "
        f"chunks, {ch_g.joined} joins, {ch_g.bursts} bursts; texts equal "
        f"{texts_equal} ({sum(map(len, ch_g.texts.values()))} chars over "
        f"{len(ch_g.texts)} streams); leaves {cmp}; slot keys (calls, "
        f"captures, replays) {json.dumps(slot)}"
        f"; host s eager {s_e:.1f}, graphed {s_g:.1f}; graphed slot "
        f"operations of the last {CHURN_TICKS[1]} ticks under "
        f"set_sync_debug_mode(\"error\"): raised nothing")
    if not (texts_equal and cmp["equal"] and once
            and kinds == set(SLOT_KEYS) and ch_g.group.total_chunk_steps
            > ch_g.group.total_steps and any(ch_g.texts.values())):
        raise SystemExit(f"phase 10 (churn, {name}): graphed and eager "
                         f"differ or a key was captured again: texts "
                         f"{texts_equal}, leaves {cmp}, slot keys {slot}")
    del runs, ch_e, ch_g
    torch.cuda.empty_cache()
    return slot


def graph_server(torch, model, name):
    """The serving form's server with clients at right contexts 13, 13, 6
    and 0 (three engine groups, batch 8), in lockstep (_serve_clients)
    and twice on each model, eager and graphed: texts equal in all four
    runs. On the graphed model the first run warms up and captures the
    keys it calls twice; the second run's engine has new state storage,
    so each key is captured again and every tick replays. Logged: each
    group's host seconds per dispatch and its graphs (keys, captures,
    recaptures, replays, capture seconds, pool bytes). Each group's slot
    keys are its own (their cfg), so within a run none is captured again
    as the groups take turns: after graphed run r no slot key has more
    than r captures."""
    from nemotron_tpu_torch.graphs import SLOT_KEYS
    from nemotron_tpu_torch.tools.graph_turns import twin

    audios = list(stream_audio(4, 48000, SEED + 2))
    modes = (13, 13, 6, 0)
    out = {}
    for form, m in (("eager", twin(model)),
                    ("graphed", twin(model, graphs=True))):
        for run in (1, 2):
            texts, stats = asyncio.run(_serve_clients(m, audios, 8, modes,
                                                      lockstep=True))
            over = {str(key): e.captures
                    for (key, _), e in m.graphs.entries.items()
                    if key[0] in SLOT_KEYS and e.captures > run}
            if over:
                raise SystemExit(f"phase 10 (server): {form} run {run}: "
                                 f"slot keys captured again as the groups "
                                 f"took turns: {over}")
            per = {rc: {"dispatch_ms": round(
                g["dispatch_seconds"] / max(g["steps"], 1) * 1e3, 2),
                "steps": g["steps"], "graphs": g["graphs"]}
                for rc, g in stats["groups"].items()}
            out[f"{form} {run}"] = texts
            log(f"[10 server] {name} {form} run {run}: clients at "
                f"R={list(modes)}, chars {[len(t) for t in texts]}; per "
                f"group {json.dumps(per)}")
        del m
        torch.cuda.empty_cache()
    want = out["eager 1"]
    bad = {k: [i for i, (a, b) in enumerate(zip(t, want)) if a != b]
           for k, t in out.items() if t != want}
    if bad or not all(want):
        raise SystemExit(f"phase 10 (server): streams {bad} differ from "
                         f"eager run 1's (chars "
                         f"{ {k: [len(t) for t in v] for k, v in out.items()} }"
                         f")")
    return out


def phase_graphs(torch, gpu, card, timers, cli_rtfs) -> dict:
    """Phase 10: the compiled tick. Graphed against eager on the parity
    schedule (GRAPH_PARITY), the server, the phase timers (graphed in
    phase 7, eager here), the CLI (phase 5's runs) and the tick table in
    turns. Returns the kernels' launches over the graphed schedules."""
    from nemotron_tpu_torch.tools.graph_turns import twin

    totals: dict = {}
    parity = {f"{name} R={mode}": graph_parity(torch, name, gpu[name], mode,
                                               totals)
              for name, mode in GRAPH_PARITY}
    missing = [k for k, v in totals.items() if not v]
    if missing or len(totals) < 5:
        raise SystemExit(f"phase 10: kernels {missing or totals} never "
                         f"launched through a replay")
    graph_churn(torch, gpu["bf16 int8-KV"], "bf16 int8-KV")
    graph_server(torch, gpu["bf16 Q8_0 int8-KV"], "bf16 Q8_0 int8-KV")
    eager = phase_timers(torch, twin(gpu["f32"]), "f32 eager", card,
                         tag="10 timers")
    log(f"[10 timers] f32 B={TIMER_B}: encoder / decoder ms per tick "
        f"graphed {timers['f32']['encoder_ms']:.2f} / "
        f"{timers['f32']['decoder_ms']:.2f} (phase 7), eager "
        f"{eager['encoder_ms']:.2f} / {eager['decoder_ms']:.2f}")
    log(f"[10 cli] RTF graphed {cli_rtfs[False]} | eager {cli_rtfs[True]}")
    table = phase_tick_times(torch, gpu, card)
    log(f"[10 table] {json.dumps(table)}")
    log(f"[10 parity] {json.dumps(parity)}")
    return totals


def main() -> int:
    import torch

    t_main = time.perf_counter()

    def elapsed(done: str) -> None:
        log(f"[time] {done} after {time.perf_counter() - t_main:.0f} s")

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{kind} x {torch.cuda.device_count()}")

    from nemotron_tpu_torch import Hparams, kernels
    from nemotron_tpu_torch.api import ASRModel
    from nemotron_tpu_torch.params import params_to, quantize_encoder_layers

    report = {k.name: {} for k in kernels.KERNELS}
    t0 = time.perf_counter()
    kernels.library()
    log(f"[2 build] {kernels.build_info['path']} in "
        f"{time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.build_info['seconds']:.2f} s)")
    for line in kernels.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[2 build] {line.strip()}")

    phase_kernels(torch, report)
    elapsed("phases 1-3")

    t0 = time.perf_counter()
    cpu_model = ASRModel.random(Hparams(), seed=SEED, device="cpu")
    cpu_model.params.joint.out_b[cpu_model.hp.blank_id] += BLANK_BIAS
    hp, vocab = cpu_model.hp, cpu_model.tokenizer.vocab
    dense = cpu_model.params
    q8 = quantize_encoder_layers(dense, bits=8)  # as bench.py --int8 does
    q4 = quantize_encoder_layers(dense, bits=4)
    bf16 = torch.bfloat16

    def model(params, device="cpu", dtype=None, kv_int8=False, block=False):
        return ASRModel(hp, params_to(params, device, dtype), vocab,
                        device=device, kv_int8=kv_int8, attn_block=block)

    def share(name, **kw):  # gpu[name]'s weights, other options
        return ASRModel(hp, gpu[name].params, vocab, device="cuda", **kw)

    gpu = {"f32": model(dense, "cuda"), "bf16": model(dense, "cuda", bf16)}
    gpu["f32 block"] = share("f32", attn_block=True)
    gpu["bf16 block"] = share("bf16", attn_block=True)
    log(f"[4 tick] random full-width params drawn, quantized to Q8_0 and "
        f"Q4_0 and placed in {time.perf_counter() - t0:.1f} s")
    ref = phase_tick(torch, cpu_model, gpu["f32"], "f32")
    phase_tick(torch, model(dense, dtype=bf16), gpu["bf16"], "bf16", ref)
    del ref
    # the attention block (B3 on the card, its plain version on the CPU)
    ref = phase_tick(torch, model(dense, block=True), gpu["f32 block"],
                     "f32 block")
    phase_tick(torch, model(dense, dtype=bf16, block=True),
               gpu["bf16 block"], "bf16 block", ref)
    phase_tick(torch, model(dense, kv_int8=True, block=True),
               share("f32", kv_int8=True, attn_block=True),
               "f32 int8-KV block", own=ref)
    # right contexts 1, 6 and 13: one k = n_phases tick, then single ticks
    # past a wrap
    for mode in RC_MODES:
        phase_tick(torch, cpu_model, gpu["f32"], "f32", mode=mode,
                   n_ticks=RC_TICKS[mode])
    del cpu_model, ref
    own = run_ticks(model(q8), tick_audio(0, N_TICKS), N_TICKS)
    gpu["f32 Q8_0 int8-KV"] = model(q8, "cuda", kv_int8=True)
    ref = phase_tick(torch, model(q8, kv_int8=True),
                     gpu["f32 Q8_0 int8-KV"], "(a) f32 Q8_0 int8-KV", own=own)
    del own
    phase_tick(torch, model(q4), model(q4, "cuda"), "(b) f32 Q4_0")
    gpu["bf16 Q8_0 int8-KV"] = model(q8, "cuda", bf16, kv_int8=True)
    phase_tick(torch, model(q8, dtype=bf16, kv_int8=True),
               gpu["bf16 Q8_0 int8-KV"], "(c) bf16 Q8_0 int8-KV", ref)
    # the same three forms at right context 13
    n13 = RC_TICKS[13]
    own = run_ticks(model(q8), tick_audio(13, n13), n13, 13)
    ref = phase_tick(torch, model(q8, kv_int8=True),
                     gpu["f32 Q8_0 int8-KV"], "(a) f32 Q8_0 int8-KV",
                     own=own, mode=13, n_ticks=n13)
    del own
    phase_tick(torch, model(q8, dtype=bf16, kv_int8=True),
               gpu["bf16 Q8_0 int8-KV"], "(c) bf16 Q8_0 int8-KV", ref,
               mode=13, n_ticks=n13)
    del ref
    elapsed("phase 4")
    gpu["bf16 int8-KV"] = ASRModel(hp, gpu["bf16"].params, vocab,
                                   device="cuda", kv_int8=True)
    gpu["bf16 Q4_0"] = model(q4, "cuda", bf16)

    L = hp.n_layers
    n_q = 11 * L  # the 11 QUANT_LAYER_FIELDS per layer
    phase_server(torch, gpu["f32"], "f32",
                 {"t1_attention": L, "q8_matmul": 0, "q4_matmul": 0})
    counts = phase_server(torch, gpu["bf16 Q8_0 int8-KV"],
                          "bf16 Q8_0 int8-KV",
                          {"t1_attention": L, "q8_matmul": n_q,
                           "q4_matmul": 0})
    counts4 = phase_server(torch, gpu["bf16 Q4_0"], "bf16 Q4_0",
                           {"t1_attention": L, "q8_matmul": 0,
                            "q4_matmul": n_q})
    counts["q4_matmul"] = counts4["q4_matmul"]
    gpu["bf16 int8-KV block"] = share("bf16", kv_int8=True, attn_block=True)
    counts["t1_attention_block"] = phase_server(
        torch, gpu["bf16 int8-KV block"], "bf16 int8-KV block",
        {"t1_attention": 0, "t1_attention_block": L, "q8_matmul": 0,
         "q4_matmul": 0})["t1_attention_block"]
    # three latency modes in one engine: two clients at 13, one at 6, one
    # at 0 (B1 on the R=0 group only: T=1 attention)
    phase_server(torch, gpu["bf16 Q8_0 int8-KV"], "bf16 Q8_0 int8-KV",
                 {"t1_attention": {0: L, 6: 0, 13: 0}, "q8_matmul": n_q,
                  "q4_matmul": 0, "t1_attention_block": 0},
                 modes=(13, 13, 6, 0))
    for k in kernels.KERNELS:
        report[k.name]["launches"] = counts[k.name]
    cli_rtfs = phase_cli(torch, hp, dense, vocab)
    elapsed("phase 5 server and cli")
    offline_counts = phase_offline(torch, hp, dense, q8, vocab, gpu, card)
    elapsed("phase 6")
    surface = phase_surface(torch, hp, gpu, vocab, card)
    elapsed("phase 7")
    log(f"[7 launches] {json.dumps(surface['launches'])}")
    phase8 = phase_diarize(torch, hp, dense, vocab, gpu["f32"], card)
    elapsed("phase 8")
    mesh_counts = phase_mesh(torch, hp, vocab, gpu, card, report)
    elapsed("phase 9")
    graph_counts = phase_graphs(torch, gpu, card, surface["timers"],
                                cli_rtfs)
    elapsed("phase 10")
    for k in kernels.KERNELS:
        report[k.name]["offline_launches"] = offline_counts[k.name]
        report[k.name]["diarize_launches"] = phase8["diarize"][k.name]
        report[k.name]["native_launches"] = phase8["native_server"][k.name]
        report[k.name]["mesh_launches"] = mesh_counts[k.name]
        report[k.name]["graph_launches"] = graph_counts[k.name]

    kernel_line = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, **report[k.name]}
        for k in kernels.KERNELS]}
    log(json.dumps(kernel_line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
