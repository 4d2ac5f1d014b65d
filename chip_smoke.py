#!/usr/bin/env python3
"""GPU smoke of nemotron_tpu_torch: builds the CUDA kernels from csrc/,
holds each against its plain PyTorch version, runs the full-width streaming
tick on the card against the CPU, and serves four TCP clients through the
port's own server — all on one CUDA card.

    python3 chip_smoke.py     # every phase; needs one CUDA card

Phases, one line each, any failure exits non-zero:
  1 device   nvidia-smi name / power limit, torch's device name
  2 build    nvcc of nemotron_tpu_torch/csrc/*.cu (seconds)
  3 kernels  each kernel vs its plain version at the main path's shapes
             (max |err|, device ms per call of both)
  4 tick     full-width random model (Hparams() defaults), 4 streams x 16
             fused ticks on the card vs the same ticks on the CPU, in f32
             and in bf16
  5 server   StreamServer on a free localhost port (batch 8), 4 concurrent
             clients x ~3 s of PCM; kernel launch counts of that run; then
             fused_tick_packed timed and profiled at B=32 and B=256 in f32
             and at B=256 in bf16
The second-to-last line is the kernels JSON, the last line the device JSON.
The package is imported from the checkout; nothing of jax or of the JAX
package `nemotron_tpu` is imported.
"""

from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
import time

import numpy as np

BLANK_BIAS = 2.4  # random weights emit ~2 tokens per 80 ms frame (bench.py)
SEED = 0
F32_ATOL = 1e-3   # card vs CPU, f32 state leaves
BF16_VS_REF = 2.0  # card vs CPU in bf16, in units of bf16's own error


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, launches: int = 50, repeats: int = 5) -> float:
    """Device ms per call of fn(): CUDA events around `launches` back-to-back
    calls, median over `repeats`. A device-side spin queued first keeps
    the device busy until every call is enqueued, so the events time the
    device work and not the host's launch overhead."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)  # ~50 ms of device spin
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def phase_kernels(torch, report):
    """Each kernel against its plain version at the main path's shapes."""
    from nemotron_tpu_torch import kernels
    from nemotron_tpu_torch.ops.attn_kernel import (t1_attention_core,
                                                    t1_attention_core_ref)
    from nemotron_tpu_torch.ops.mel import padded_window
    from nemotron_tpu_torch.ops.mel_kernel import mel_frames, mel_frames_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    B, H, Dh, S = 32, 8, 128, 78
    scale = 1.0 / np.sqrt(Dh)
    ok = True
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        def t(*shape):
            return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                                device=dev).to(dtype)

        q, kn, vn = t(B, H, Dh), t(B, H, Dh), t(B, H, Dh)
        kb, vb = t(B, H, S, Dh), t(B, H, S, Dh)
        # position scores * scale + a random validity window per stream:
        # dead slots at -1e9 (weight exactly 0); the new frame always live
        pm = (rng.standard_normal((B, H, S + 1)) * scale).astype(np.float32)
        lo = rng.integers(0, 9, B)
        valid = rng.integers(1, 71, B)
        for b in range(B):
            live = np.zeros(S + 1, bool)
            live[lo[b] + 70 - valid[b]:lo[b] + 70] = True
            live[S] = True
            pm[b, :, ~live] = -1e9
        pm = torch.tensor(pm, device=dev)
        args = (q, kn, vn, pm, kb, vb)
        got = t1_attention_core(*args).float()
        want = t1_attention_core_ref(*args).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ms = cuda_ms(lambda: t1_attention_core(*args))
        plain_ms = cuda_ms(lambda: t1_attention_core_ref(*args))
        name = "f32" if dtype == torch.float32 else "bf16"
        good = bool(torch.isfinite(got).all()) and err <= atol
        ok &= good
        log(f"[3 kernels] t1_attention {name} B={B} H={H} S_buf={S} Dh={Dh}: "
            f"max|err| {err:.3e} (atol {atol:g}) {'ok' if good else 'FAIL'}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if dtype == torch.float32:
            report["t1_attention"] = dict(max_abs_err=err, ms=ms,
                                          plain_ms=plain_ms)
        else:
            report["t1_attention"]["max_abs_err_bf16"] = err

    n_frames, n_mels = 8, 128
    n_buf = (n_frames - 1) * 160 + 512
    buf = torch.tensor(rng.standard_normal((B, n_buf)).astype(np.float32)
                       * 0.1, device=dev)
    fb = torch.tensor(rng.uniform(0, 1, (n_mels, 257)).astype(np.float32),
                      device=dev)
    win = padded_window(torch.tensor(np.hanning(400).astype(np.float32),
                                     device=dev))
    got = mel_frames(buf, win, fb, n_frames)
    want = mel_frames_ref(buf, win, fb, n_frames)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ms = cuda_ms(lambda: mel_frames(buf, win, fb, n_frames))
    plain_ms = cuda_ms(lambda: mel_frames_ref(buf, win, fb, n_frames))
    good = bool(torch.isfinite(got).all()) and err <= 1e-3
    ok &= good
    log(f"[3 kernels] mel_frames B={B} frames={n_frames} mels={n_mels}: "
        f"max|err| {err:.3e} (atol 1e-3) {'ok' if good else 'FAIL'}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    report["mel_frames"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
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


def run_ticks(model, audio: np.ndarray, n_ticks: int):
    """n_ticks all-active fused ticks over `audio` [B, >= 96 + n*1280],
    with the engine's stream priming and wrap compaction."""
    from nemotron_tpu_torch.streaming.engine import PRIME_SAMPLES, prime_carry

    cfg = model.cache_config(0)
    b, shift = audio.shape[0], cfg.shift_samples
    state = model.init_stream_state(b, cfg)
    tails, lasts = zip(*(prime_carry(a[:PRIME_SAMPLES]) for a in audio))
    state = model.prime_frontend(state, np.ones(b, bool), np.stack(tails),
                                 np.asarray(lasts, np.float32))
    toks, phase = [], 0
    for i in range(n_ticks):
        off = PRIME_SAMPLES + i * shift
        packed = model.pack_tick_inputs(
            audio[:, off:off + shift], np.full(b, cfg.valid_out_len),
            np.zeros(b), None)
        state, tokens = model.fused_tick_packed(
            cfg, state, model.put_batch(packed), True, phase=phase)
        toks.append(tokens.cpu().numpy())
        phase += 1
        if phase == cfg.n_phases:
            state = model.compact_state(cfg, state)
            phase = 0
    return state, np.concatenate(toks, axis=1)


def phase_tick(torch, cpu_model, gpu_model, name: str, ref=None):
    """16 ticks of 4 streams on the card and on the CPU from the same state.

    f32: K/V, conv cache and decoder state within F32_ATOL, the integer
    leaves equal. Returns the CPU's (state, tokens) as the reference for
    bf16.
    bf16 (`ref` = the f32 CPU run on the same audio and weights): the two
    devices round bf16 at different points, and the 24 layers carry the
    differences on, so the bound is relative to bf16's own error: for each
    token-independent cache, max|card - cpu| <= BF16_VS_REF x max|cpu -
    f32|. Tokens are reported as their agreement with the f32 run (random
    weights have near-tie argmaxes that bf16 rounding flips)."""
    n_ticks, b = 16, 4
    audio = stream_audio(b, 96 + n_ticks * 1280, SEED + 1)
    t0 = time.perf_counter()
    s_gpu, tok_gpu = run_ticks(gpu_model, audio, n_ticks)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_cpu, tok_cpu = run_ticks(cpu_model, audio, n_ticks)
    t_cpu = time.perf_counter() - t0
    hp = gpu_model.hp
    head = (f"[4 tick] {name} B={b} x {n_ticks} ticks (d_model {hp.d_model}, "
            f"{hp.n_layers} layers): ")
    tail = f"; card {t_gpu:.2f} s incl. first use, cpu {t_cpu:.2f} s"

    def err(a, c):
        return float((a.cpu().float() - c.cpu().float()).abs().max())

    bad = []
    if ref is None:
        pairs = {n: (getattr(s_gpu, n), getattr(s_cpu, n))
                 for n in ("k_cache", "v_cache", "conv_cache")}
        pairs.update({"decode." + n: (getattr(s_gpu.decode, n),
                                      getattr(s_cpu.decode, n))
                      for n in ("h", "c")})
        errs = {n: err(g, c) for n, (g, c) in pairs.items()}
        bad = [f"{n} {e:.3e}" for n, e in errs.items()
               if not e <= F32_ATOL or
               not bool(torch.isfinite(pairs[n][0]).all())]
        same = torch.equal(s_gpu.cache_valid.cpu(), s_cpu.cache_valid) and \
            all(torch.equal(getattr(s_gpu.decode, n).cpu(),
                            getattr(s_cpu.decode, n))
                for n in ("prev_token", "frame_offset"))
        if not same:
            bad.append("integer leaves differ")
        log(head + f"max|gpu-cpu| {fmt(errs)} (atol {F32_ATOL:g}); tokens "
            f"equal: {bool(np.array_equal(tok_gpu, tok_cpu))} "
            f"({int((tok_gpu >= 0).sum())} emitted on the card)" + tail)
    else:
        s_ref, tok_ref = ref
        errs, ref_errs = {}, {}
        for n in ("k_cache", "v_cache", "conv_cache"):
            g, c, r = getattr(s_gpu, n), getattr(s_cpu, n), getattr(s_ref, n)
            errs[n], ref_errs[n] = err(g, c), err(c, r)
            if not (bool(torch.isfinite(g).all())
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


async def _serve_clients(model, audios, batch):
    from nemotron_tpu_torch.shared.client import transcribe_file
    from nemotron_tpu_torch.serving.server import StreamServer

    srv = StreamServer(model, batch_per_group=batch)
    server = await srv.start("127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    try:
        texts = await asyncio.wait_for(asyncio.gather(*[
            transcribe_file(a, host="127.0.0.1", port=port, chunk_ms=200)
            for a in audios]), timeout=300)
    finally:
        await srv.stop(server)
    return texts, srv.engine.stats()


class TickLoop:
    """All-active fused ticks on a fresh batch-b state, one per call, with
    the engine's phase advance and wrap compaction."""

    def __init__(self, model, b: int):
        self.model, self.b = model, b
        self.cfg = model.cache_config(0)
        self.state = model.init_stream_state(b, self.cfg)
        self.rng = np.random.default_rng(SEED + b)
        self.phase = 0

    def __call__(self):
        cfg, b = self.cfg, self.b
        audio = (self.rng.standard_normal((b, cfg.shift_samples)) * 3000
                 ).astype(np.int16)
        packed = self.model.put_batch(self.model.pack_tick_inputs(
            audio, np.ones(b), np.zeros(b), None))
        self.state, _ = self.model.fused_tick_packed(
            cfg, self.state, packed, True, phase=self.phase)
        self.phase += 1
        if self.phase == cfg.n_phases:
            self.state = self.model.compact_state(cfg, self.state)
            self.phase = 0


def time_ticks(torch, model, b: int, n: int = 24, warmup: int = 4) -> float:
    """Median host ms of one all-active fused tick at batch b (synchronised
    before and after each tick)."""
    loop, times = TickLoop(model, b), []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    del loop
    torch.cuda.empty_cache()
    return statistics.median(times)


def profile_ticks(torch, model, b: int, n: int = 8):
    """Device kernel time per tick by kernel name (torch.profiler, CUPTI):
    returns (total device ms per tick, [(name, ms per tick, calls per
    tick)] sorted by time), or None if the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loop = TickLoop(model, b)
    for _ in range(4):
        loop()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            loop()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    del loop
    torch.cuda.empty_cache()
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def phase_server(torch, model, report):
    from nemotron_tpu_torch import kernels

    audios = list(stream_audio(4, 48000, SEED + 2))
    kernels.reset_counts()
    texts, stats = asyncio.run(_serve_clients(model, audios, batch=8))
    counts = {k.name: k.launches for k in kernels.KERNELS}
    group = stats["groups"][0]
    steps = group["chunk_steps"]
    log(f"[5 server] 4 clients x 3.0 s, batch 8: every stream got OP_ENDED; "
        f"transcript chars {[len(t) for t in texts]}; launches {counts} over "
        f"{steps} chunk steps")
    log(f"[5 server] stats {json.dumps(stats)}")
    for k in kernels.KERNELS:
        report[k.name]["launches"] = k.launches
    n_layers = model.hp.n_layers
    if not any(texts):
        raise SystemExit("phase 5: every transcript is empty")
    if counts["t1_attention"] != n_layers * steps or \
            counts["mel_frames"] < steps or steps == 0:
        raise SystemExit(f"phase 5: kernel launches {counts} do not match "
                         f"{steps} chunk steps x {n_layers} layers")


def phase_tick_times(torch, models, card: str):
    """fused_tick_packed at full width, all-active: host ms per tick, then
    the device's kernel time per tick from a profile of the same loop."""
    for name, b in (("f32", 32), ("f32", 256), ("bf16", 256)):
        model = models[name]
        ms = time_ticks(torch, model, b)
        log(f"[5 tick time] B={b} all-active {name}: {ms:.2f} ms/tick, "
            f"{80.0 / ms * b:.0f} real-time 80 ms streams ({card})")
        prof = profile_ticks(torch, model, b)
        if prof is None:
            log(f"[5 profile] {name} B={b}: device time not measured (the "
                "trace holds no device events)")
            continue
        dev_ms, rows = prof
        log(f"[5 profile] {name} B={b}: device busy {dev_ms:.2f} ms of a "
            f"{ms:.2f} ms tick (idle share {max(0.0, 1 - dev_ms / ms):.2f}); "
            f"{sum(r[2] for r in rows):.0f} kernels/tick ({card})")
        for kname, kms, calls in rows[:8]:
            log(f"[5 profile]   {kms:7.3f} ms/tick {calls:6.1f} calls  "
                f"{kname[:90]}")
        attn = [r for r in rows if "t1_attention_kernel" in r[0]]
        if attn:
            per_launch = attn[0][1] / attn[0][2]
            hp = model.hp
            kv_bytes = (2 * b * hp.n_heads * hp.d_head
                        * model.params.pos_emb.element_size()
                        * model.cache_config(0).cache_buf_len(hp))
            log(f"[5 profile] {name} B={b}: t1_attention "
                f"{per_launch * 1e3:.1f} us per launch, "
                f"{kv_bytes / per_launch / 1e6:.0f} GB/s of K/V ({card})")


def main() -> int:
    import torch

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
    from nemotron_tpu_torch.params import params_to

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

    t0 = time.perf_counter()
    cpu_model = ASRModel.random(Hparams(), seed=SEED)
    cpu_model.params.joint.out_b[cpu_model.hp.blank_id] += BLANK_BIAS
    hp, vocab = cpu_model.hp, cpu_model.tokenizer.vocab
    gpu = {"f32": ASRModel(hp, params_to(cpu_model.params, "cuda"), vocab,
                           device="cuda"),
           "bf16": ASRModel(hp, params_to(cpu_model.params, "cuda",
                                          torch.bfloat16), vocab,
                            device="cuda")}
    log(f"[4 tick] random full-width params drawn and placed in "
        f"{time.perf_counter() - t0:.1f} s")
    ref = phase_tick(torch, cpu_model, gpu["f32"], "f32")
    cpu_bf16 = ASRModel(hp, params_to(cpu_model.params, dtype=torch.bfloat16),
                        vocab)
    del cpu_model
    phase_tick(torch, cpu_bf16, gpu["bf16"], "bf16", ref)
    del cpu_bf16, ref

    phase_server(torch, gpu["f32"], report)
    phase_tick_times(torch, gpu, card)

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
