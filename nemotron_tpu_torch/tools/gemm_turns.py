"""Time kernels B1 (T=1 attention), B3 (the fused attention block), B4 /
B5 (Q8_0 / Q4_0 linears, bf16 and f32 activations) and B2 (log-mel frames),
and the host time of a full-width tick, of two or more checkouts of the
repo in turns on one card,
as one call of the card allows a fair comparison: each tree runs in a
process of its own (it builds its own kernels into its own `_build/`), in
the order given, e.g. parent, change, change, parent.

    python3 nemotron_tpu_torch/tools/gemm_turns.py \\
        --tree parent=_archive/parent --tree change=. \\
        --tree change=. --tree parent=_archive/parent \\
        [--only b1 --only b3 --only b4b5 --only mel --only tick
         --only e2e] [--probe[=f32|gemm|large]] [--plans]

Per tree and case: device ms per call (CUDA events around 50 calls behind
a device spin, median of 7). B1 and B3 at chip_smoke.py phase 3's shapes:
B in {32, 256}, H=8, S_buf=78, Dh=128 (B3: D=1024), f32 and bf16, dense
and int8 caches, random validity windows with garbage in the dead slots.
B4 / B5 also give `dense_ms`, torch.matmul of x and the weight dequantized
to x's type beforehand (cuBLAS's dense product of the same shape; in f32
its FFMA product, TF32 off), at the main path's (N, K) and M in {32, 141,
256} in bf16, M in {141, 256} in f32, and in both at the rows of many
streams, LARGE_ROWS: a B=256 tick at right context 1 / 6 / 13 (512,
1,792, 3,584) and the offline path's (769, 6,152, 16,384); each row with
its bytes, bound and the tree's plan. `tick`: host ms of one all-active
fused tick at full width and B=256 (random weights from seed 0; the tick
synchronised before and after, median of 48 after 8 warm-up ticks) in bf16,
in f32, bf16 and bf16 with int8 K/V through the attention block, and in
f32 with Q8_0 encoder weights (B4 in f32) and int8 K/V. `e2e`: bf16 Q8_0
graphed end to end (e2e_rows: offline B=8 x 60 s, the B=256 int8-K/V
tick at right context 13 and 0; host time and device busy). `mel`: B2 at
the shapes its paths run (MEL_SHAPES: B x frames 256 x 8, the tick's
headline, to 1 x 16,376, one offline segment), 128 mels, white noise, with the dense uniform filterbank of random_params and
a slaney one (`slaney_filterbank`), each beside
`rfft_ms`: torch.fft.rfft of the unfolded windowed frames, the power, the
filterbank by torch.matmul and the log (cuFFT; a yardstick, not called by
the port). `--only` picks the groups (all six by default). `--profile`
adds each of B3's launches' device us. `--probe` then times the change's B1 built as
measurement variants (T1_PROBE: without the scores and context, without
the copies), its B4 / B5 as measurement variants of
csrc/wq_gemm_sm90.cuh (WQ_SM90_PROBE: without the dequantization, without
the wgmma, without both; WQ_SM90_MAX_STAGES: a deeper ring) and of
csrc/wq_gemm_large.cuh (WQ_LARGE_PROBE: without the epilogue's stores,
without the wgmma, without both), each on ops/quant.py:gemm_plan's plan,
with one more case of a single pipeline
step (K = 64) for the fixed cost of a call, and its B3 and B4 / B5 with
the f32 body csrc/wq_matmul.cuh built as WQ_F32_PROBE variants (without
the staging of later steps; without all but one column of math);
`--probe=f32` builds the last two only, `--probe=gemm` the B4 / B5 bodies'
without the deeper rings, `--probe=large` the large-M form's only. Their
outputs are not the function's. `--plans` adds the change's f32 B4 at
every plan ops/quant.py:f32_plan weighs (batch tile x splits within one
wave), the data its cost model is fitted to, the change's bf16 B4 / B5 at
each of LARGE_ROWS in every form gemm_plan picks from (form_rows: the
data of its crossover and tile choice), and with `mel` B2 at every
tile ops/mel_kernel.py:mel_plan picks from. Prints one line per case;
`--json PATH` also writes all of it there as JSON.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import sys

import numpy as np

try:
    from . import turns
except ImportError:  # run as a script: this directory leads the path
    import turns

GROUPS = ("b1", "b3", "b4b5", "mel", "tick", "e2e")
SHAPES = ((4096, 1024), (1024, 4096), (2048, 1024), (1024, 1024))
# B4 / B5 rows: the R=0 tick's (B = 32, 141, 256), a B=256 tick's at right
# context 1 / 6 / 13 (chip_smoke.RC_ROWS), the offline path's (one and
# eight 60 s files, eight full segments: chip_smoke.OFFLINE_ROWS)
LARGE_ROWS = (512, 1792, 3584, 769, 6152, 16384)
BATCHES = (32, 141, 256) + LARGE_ROWS
F32_BATCHES = (141, 256) + LARGE_ROWS
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak rate
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}


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
    ("probe: large, no stores", ("-DWQ_LARGE_PROBE=1",)),
    ("probe: large, no wgmma", ("-DWQ_LARGE_PROBE=2",)),
    ("probe: large, neither", ("-DWQ_LARGE_PROBE=3",)),
)
# measurement variants of the change's f32 body (B3, B4 / B5 in f32)
F32_PROBES = (
    ("f32 probe: math only", ("-DWQ_F32_PROBE=1",)),
    ("f32 probe: staging only", ("-DWQ_F32_PROBE=2",)),
)
ONE_STEP = (1024, 64)  # (N, K) of a single pipeline step, one split
# measurement variants of the change's B1: label, extra nvcc flags
B1_PROBES = (
    ("b1 probe: full", ()),
    ("b1 probe: no math", ("-DT1_PROBE=1",)),
    ("b1 probe: no copies", ("-DT1_PROBE=2",)),
)


ATTN_BATCHES = (32, 256)
H, DH, S_BUF = 8, 128, 78


def _live(rng, b):
    """Random validity windows of b streams over S_BUF slots (+ the new
    frame, always live)."""
    live = np.zeros((b, S_BUF + 1), bool)
    lo, valid = rng.integers(0, 9, b), rng.integers(1, 71, b)
    for i in range(b):
        live[i, lo[i] + 70 - valid[i]:lo[i] + 70] = True
    live[:, S_BUF] = True
    return live


def _caches(torch, rng, dev, dtype, int8, live):
    """K and V caches [B, H, S_BUF, DH], int8 ones with garbage codes and
    scales in the dead slots."""
    from nemotron_tpu_torch.ops.kvquant import quantize_kv

    b = live.shape[0]
    bufs = [torch.tensor(rng.standard_normal((b, H, S_BUF, DH)).astype(
        np.float32), device=dev).to(dtype) for _ in range(2)]
    if int8:
        bufs = [quantize_kv(x) for x in bufs]
        dead = torch.tensor(~live[:, :S_BUF], device=dev)[:, None, :]
        for buf in bufs:
            buf.q.masked_fill_(dead[..., None], 127)
            buf.s.masked_fill_(dead, 3.0e4)
    return bufs


def slaney_filterbank(n_mels: int, sr: int = 16000, n_fft: int = 512,
                      fmin: float = 0.0, fmax: float = 8000.0) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney') [n_mels, n_fft/2 + 1]
    f32: the kind of filterbank NeMo ships in the GGUF (triangles of about
    two non-zero bins each), in numpy."""
    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10)
                                                    / 1000.0)
                        / (np.log(6.4) / 27.0), f / (200.0 / 3))

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0)
                                                    * (m - 15.0)),
                        m * (200.0 / 3))

    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - fft_freqs[None, :]
    weights = np.maximum(0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                       ramps[2:] / fdiff[1:, None]))
    enorm = 2.0 / (pts[2:n_mels + 2] - pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def rfft_mel(torch, buf, window512, filterbank, n_frames: int):
    """The log-mel function by cuFFT: torch.fft.rfft of the unfolded,
    windowed frames, the power, the filterbank by torch.matmul, the log.
    B2's yardstick (`rfft_ms`); the port never calls it."""
    spec = torch.fft.rfft(buf.unfold(-1, 512, 160)[:, :n_frames] * window512)
    power = spec.real * spec.real + spec.imag * spec.imag
    return torch.log(torch.matmul(power, filterbank.T) + 2.0 ** -24)


def mel_exact(torch, buf, window512, filterbank, n_frames: int):
    """The log-mel function in float64 on the same f32 inputs (the window
    product in f32, as both versions take it): the exact value B2 and its
    plain version are held to where the plain version's f32 DFT-matmul
    strays (a loud tone)."""
    frames = (buf.unfold(-1, 512, 160)[:, :n_frames] * window512).double()
    power = torch.fft.rfft(frames).abs() ** 2
    return torch.log(power @ filterbank.double().T + 2.0 ** -24)


# (B, frames): the tick's headline, a tick of 32 streams, the session's
# chunk, mel_full of 60 s, the ticks at right context 1 / 6 / 13 and the
# session's chunk at 13, one offline segment (16,376 frames, 163.76 s)
MEL_SHAPES = ((256, 8), (32, 8), (1, 8), (1, 6000), (256, 16), (256, 56),
              (256, 112), (1, 112), (1, 16376))


def mel_cases(torch, dev, rng):
    """(label, B, frames, buf, window512, filterbank) of B2's timed cases:
    white noise (std 0.1), 128 mels."""
    from nemotron_tpu_torch.ops.mel import padded_window

    win = padded_window(torch.tensor(np.hanning(400).astype(np.float32),
                                     device=dev))
    dense = torch.tensor(rng.uniform(0, 1, (128, 257)).astype(np.float32),
                         device=dev)
    slaney = torch.tensor(slaney_filterbank(128), device=dev)
    for b, f in MEL_SHAPES:
        buf = torch.tensor((rng.standard_normal((b, (f - 1) * 160 + 512))
                            * 0.1).astype(np.float32), device=dev)
        for kind, fb in (("dense", dense), ("slaney", slaney)):
            yield f"B={b} x {f} {kind}", b, f, buf, win, fb


def mel_rows(torch, dev, rng, plans: bool = False) -> list:
    """B2 and its rfft yardstick at each case; with `plans`, B2 (the
    change's entry point) at every tile of ops/mel_kernel.FRAME_TILES."""
    from nemotron_tpu_torch import kernels
    from nemotron_tpu_torch.ops import mel_kernel as mk

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for case, b, f, buf, win, fb in mel_cases(torch, dev, rng):
        if not plans:
            rows.append(dict(
                kernel="mel_frames", case=case,
                ms=cuda_ms(torch, lambda: mk.mel_frames(buf, win, fb, f)),
                rfft_ms=cuda_ms(torch, lambda: rfft_mel(torch, buf, win, fb,
                                                        f))))
            continue
        lay = mk.filterbank_layout(fb)
        out = torch.empty((b, f, fb.shape[0]), device=dev)
        tw = mk.fft_twiddles(dev)
        chosen = mk.mel_plan(b, f, mk.wide_bands(lay), sms)
        for tile in mk.FRAME_TILES:
            args = (buf.data_ptr(), win.data_ptr(), tw.data_ptr(),
                    lay.weights.data_ptr(), lay.bands.data_ptr(),
                    out.data_ptr(), b, buf.shape[1], f, fb.shape[0],
                    lay.weights.numel(), tile)
            rows.append(dict(
                kernel="mel_frames plan", case=f"{case} tile {tile}"
                + (" (chosen)" if tile == chosen else ""),
                ms=cuda_ms(torch, lambda: kernels.MEL_FRAMES.launch(
                    "mel_frames_f32", *args))))
    return rows


def kernel_name(key: str) -> str:
    """A profiler event's kernel name without its return type, its
    anonymous namespace and its trailing argument list:
    'void (anonymous namespace)::k<float, 128>(float const*, int)' ->
    'k<float, 128>'."""
    name, depth = key, 0
    if name.endswith(")"):
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = name.replace("(anonymous namespace)::", "")
    return name[5:] if name.startswith("void ") else name


def launch_us(torch, fn, calls: int = 20) -> dict:
    """Device us per call of each kernel fn launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            name = kernel_name(e.key)
            out[name] = out.get(name, 0.0) + e.self_device_time_total / calls
    return out


TICK_B = 256


def tick_ms(torch, model, b: int, n: int = 48, warmup: int = 8) -> float:
    """Median host ms of one all-active fused tick at batch b on a fresh
    state (synchronised before and after each tick), with the engine's
    phase advance and wrap compaction."""
    import time

    cfg = model.cache_config(0)
    state = model.init_stream_state(b, cfg)
    rng = np.random.default_rng(b)
    phase, times = 0, []
    for i in range(warmup + n):
        audio = (rng.standard_normal((b, cfg.shift_samples)) * 3000).astype(
            np.int16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed = model.put_batch(model.pack_tick_inputs(
            audio, np.ones(b), np.zeros(b), None))
        state, _ = model.fused_tick_packed(cfg, state, packed, True,
                                           phase=phase)
        phase += 1
        if phase == cfg.n_phases:
            state = model.compact_state(cfg, state)
            phase = 0
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def tick_rows(torch) -> list:
    """Host ms per tick of the full-width model at B=TICK_B: bf16; f32,
    bf16 and bf16 int8-K/V through the attention block; f32 Q8_0 int8-K/V
    (B4 in f32)."""
    from nemotron_tpu_torch import Hparams
    from nemotron_tpu_torch.api import ASRModel
    from nemotron_tpu_torch.params import params_to, quantize_encoder_layers

    f32 = ASRModel.random(Hparams(), seed=0, device="cuda")
    hp, vocab = f32.hp, f32.tokenizer.vocab
    bf16 = params_to(f32.params, "cuda", torch.bfloat16)
    rows = []
    for name, params, kw in (
            ("bf16", bf16, {}),
            ("f32 block", f32.params, dict(attn_block=True)),
            ("bf16 block", bf16, dict(attn_block=True)),
            ("bf16 int8-KV block", bf16, dict(attn_block=True,
                                              kv_int8=True)),
            ("f32 Q8_0 int8-KV", quantize_encoder_layers(f32.params, bits=8),
             dict(kv_int8=True))):
        model = ASRModel(hp, params, vocab, device="cuda", **kw)
        rows.append(dict(kernel="tick", case=f"{name} B={TICK_B}",
                         ms=tick_ms(torch, model, TICK_B)))
        del model
        torch.cuda.empty_cache()
    return rows


E2E_FILES, E2E_SECS = 8, 60  # the offline batch: 8 files of 60 s


def e2e_rows(torch) -> list:
    """End to end with Q8_0 encoder matrices in bf16 (B4 at the paths'
    rows), graphed, at full width on chip_smoke.py's random model (seed
    0): one transcribe_audios call on E2E_FILES x E2E_SECS s files (the
    blank bias at chip_smoke.OFFLINE_BIAS; B4 at M = 8 x 769), host s
    (median of 3 after a warm-up and a capture call) and device busy s
    (one profiled call); and an all-active B=256 tick with int8 K/V at
    right context 13 (M = 3,584) and 0 (M = 256), host ms (median) and
    device busy ms per tick (chip_smoke.tick_row)."""
    import time

    import chip_smoke as cs
    from nemotron_tpu_torch import Hparams
    from nemotron_tpu_torch.api import ASRModel
    from nemotron_tpu_torch.params import params_to, quantize_encoder_layers

    cpu = ASRModel.random(Hparams(), seed=cs.SEED, device="cpu")
    cpu.params.joint.out_b[cpu.hp.blank_id] += cs.BLANK_BIAS
    hp, vocab = cpu.hp, cpu.tokenizer.vocab
    q8 = params_to(quantize_encoder_layers(cpu.params, bits=8), "cuda",
                   torch.bfloat16)
    rows = []
    model = cs.offline_model(ASRModel(hp, q8, vocab, device="cuda"),
                             cs.OFFLINE_BIAS)
    audios = list(cs.stream_audio(E2E_FILES, E2E_SECS * 16000, cs.SEED + 10))
    for _ in range(2):
        model.transcribe_audios(audios)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.transcribe_audios(audios)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prof = cs.profile_rows(torch, lambda: model.transcribe_audios(audios),
                           n=1, warmup=0)
    host = statistics.median(times)
    rows.append(dict(kernel="e2e", case=f"offline bf16 Q8_0 B={E2E_FILES} x "
                     f"{E2E_SECS} s graphed", ms=host * 1e3,
                     busy_ms=None if prof is None else prof[0],
                     audio_s_per_s=E2E_FILES * E2E_SECS / host))
    model.drop_offline_graphs()
    del model
    torch.cuda.empty_cache()
    for mode in (13, 0):
        model = ASRModel(hp, q8, vocab, device="cuda", kv_int8=True)
        ms, prof = cs.tick_row(torch, model, TICK_B, mode,
                               *((6, 3) if mode else (16, 4)))
        rows.append(dict(kernel="e2e", case=f"tick bf16 Q8_0 int8-KV "
                         f"B={TICK_B} R={mode} graphed", ms=ms,
                         busy_ms=None if prof is None else prof[0]))
        del model
        torch.cuda.empty_cache()
    return rows


def attn_rows(torch, dev, rng, b3: bool, profile: bool = False):
    """B1 (and with b3 B3) at phase 3's shapes: one row per case; with
    `profile`, B3's rows also carry each of its launches' device us."""
    from nemotron_tpu_torch.ops.attn_block import t1_attention_block
    from nemotron_tpu_torch.ops.attn_kernel import t1_attention_core

    D = H * DH
    rows = []
    for b, int8, dtype in itertools.product(
            ATTN_BATCHES, (False, True), (torch.float32, torch.bfloat16)):
        name = (f"{'int8' if int8 else 'dense'} "
                f"{'f32' if dtype == torch.float32 else 'bf16'} B={b}")

        def t(*shape, scale=1.0, dt=dtype):
            return torch.tensor((rng.standard_normal(shape) * scale).astype(
                np.float32), device=dev).to(dt)

        live = _live(rng, b)
        kb, vb = _caches(torch, rng, dev, dtype, int8, live)
        pm = t(b, H, S_BUF + 1, scale=DH ** -0.5, dt=torch.float32)
        pm.masked_fill_(torch.tensor(~live, device=dev)[:, None, :], -1e9)
        args = (t(b, H, DH), t(b, H, DH), t(b, H, DH), pm, kb, vb)
        rows.append(dict(kernel="t1_attention", case=name, ms=cuda_ms(
            torch, lambda: t1_attention_core(*args))))
        if not b3:
            continue
        a = dict(x=t(b, D), ln_w=1 + t(D, scale=0.1), ln_b=t(D, scale=0.1),
                 q_w=t(D, D, scale=D ** -0.5), k_w=t(D, D, scale=D ** -0.5),
                 v_w=t(D, D, scale=D ** -0.5), out_w=t(D, D, scale=D ** -0.5),
                 bias_u=t(H, DH, scale=0.1), bias_v=t(H, DH, scale=0.1),
                 pp=t(H, DH, S_BUF + 1, scale=0.5, dt=torch.float32),
                 mask=torch.tensor(np.where(live, 0.0, -1e9).astype(
                     np.float32), device=dev).to(dtype),
                 k_buf=kb, v_buf=vb, n_heads=H, d_head=DH)
        rows.append(dict(kernel="t1_attention_block", case=name, ms=cuda_ms(
            torch, lambda: t1_attention_block(**a))))
        if profile:
            rows[-1]["launch_us"] = launch_us(
                torch, lambda: t1_attention_block(**a))
    return rows


def plan_rows(torch, dev, rng, sms) -> list:
    """f32 B4 at M in F32_BATCHES and the main path's (N, K), once per plan
    that ops/quant.py:f32_plan weighs: every batch tile and every K split
    whose blocks fit one wave."""
    from nemotron_tpu_torch import kernels
    from nemotron_tpu_torch.ops import quant

    rows = []
    for n, k in SHAPES:
        qt = quant.quantize_q8((rng.standard_normal((n, k)) / np.sqrt(k))
                               .astype(np.float32)).to(dev)
        steps = -(-k // quant.F32_STEP)
        for m in F32_BATCHES:
            x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32),
                             device=dev)
            y = torch.empty((m, n), device=dev)
            chosen = quant.f32_plan(m, n, k, sms)
            for bm in quant.F32_M_TILES:
                tiles = -(-m // bm) * -(-n // quant.F32_ROWS)
                for want in range(1, min(steps, quant.F32_MAX_SPLITS) + 1):
                    spp = -(-steps // want)
                    if -(-steps // spp) != want or tiles * want > max(
                            sms, tiles):
                        continue
                    p = quant.F32Plan(bm, -(-m // bm), tiles // -(-m // bm),
                                      want, steps, spp)
                    ws, cnt = quant.f32_scratch(p, dev)
                    args = (x.data_ptr(), qt.w_i8.data_ptr(),
                            qt.scales.data_ptr(), y.data_ptr(),
                            0 if ws is None else ws.data_ptr(),
                            0 if cnt is None else cnt.data_ptr(), m, n, k,
                            bm, want, spp)
                    rows.append(dict(
                        kernel="q8_matmul plan", m=m, n=n, k=k, bm=bm,
                        splits=want, chosen=p == chosen, ms=cuda_ms(
                            torch, lambda: kernels.Q8_MATMUL.launch(
                                "q8_matmul_f32", *args))))
    return rows


def form_rows(torch, dev, rng, sms) -> list:
    """bf16 B4 / B5 at each of LARGE_ROWS and the main path's (N, K) in
    every form ops/quant.py:gemm_plan chooses between: the M <= 256 form
    (swap_plan) and the large-M form at each weight-row tile (large_plan,
    LARGE_BN), each held against the plain version (max |diff| / max |y|)
    and, for the large-M form, each launch's device us (torch.profiler):
    the data its crossover and tile choice are fitted to."""
    from nemotron_tpu_torch import kernels
    from nemotron_tpu_torch.ops import quant

    rows = []
    for bits in (8, 4):
        qz = quant.quantize_q8 if bits == 8 else quant.quantize_q4
        ref = quant.linear_q8_ref if bits == 8 else quant.linear_q4_ref
        kern = kernels.Q8_MATMUL if bits == 8 else kernels.Q4_MATMUL
        prefix = f"q{bits}_matmul"
        for n, k in SHAPES:
            qt = qz((rng.standard_normal((n, k)) / np.sqrt(k)).astype(
                np.float32)).to(dev)
            codes = qt.w_i8 if bits == 8 else qt.w_packed
            for m in LARGE_ROWS:
                x = torch.tensor(rng.standard_normal((m, k)).astype(
                    np.float32), device=dev).to(torch.bfloat16)
                y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
                want = ref(x, qt).float()
                ptrs = (x.data_ptr(), codes.data_ptr(), qt.scales.data_ptr(),
                        y.data_ptr())
                chosen = quant.gemm_plan(m, n, k, bits, sms)
                plans = [quant.swap_plan(m, n, k, bits, sms)] + [
                    quant.large_plan(m, n, k, sms, bn)
                    for bn in quant.LARGE_BN]
                for p in plans:
                    if isinstance(p, quant.LargePlan):
                        wbuf = torch.empty((n, k), dtype=torch.bfloat16,
                                           device=dev)

                        def fn(p=p, wbuf=wbuf):
                            kern.launch(f"{prefix}_bf16_large", *ptrs,
                                        wbuf.data_ptr(), m, n, k, p.bn,
                                        p.blocks)
                        form = f"large bn {p.bn} blocks {p.blocks}"
                    else:
                        ws = (torch.empty((p.splits, m, n),
                                          dtype=torch.float32, device=dev)
                              if p.splits > 1 else None)

                        def fn(p=p, ws=ws):
                            kern.launch(f"{prefix}_bf16", *ptrs,
                                        0 if ws is None else ws.data_ptr(),
                                        m, n, k, p.m_tile, p.splits,
                                        p.steps_per)
                        form = (f"swap m_tile {p.m_tile} splits {p.splits}")
                    y.zero_()
                    fn()
                    torch.cuda.synchronize()
                    err = float((y.float() - want).abs().max()
                                / want.abs().max())
                    row = dict(kernel=f"{prefix} form", bits=bits, m=m, n=n,
                               k=k, form=form, chosen=p == chosen,
                               rel_err=err, ms=cuda_ms(torch, fn))
                    if isinstance(p, quant.LargePlan):
                        row["launch_us"] = launch_us(torch, fn)
                    rows.append(row)
    return rows


def gemm_work(quant, bits: int, dtype, m: int, n: int, k: int,
              sms: int) -> dict:
    """The least bytes a B4 / B5 call moves (codes, scales, x and y, each
    once), its operations, its bound on an H100 SXM, and the plan the
    tree's ops/quant.py takes for it (as a dict: its fields are the
    tree's own)."""
    import dataclasses

    esize = 2 if str(dtype).endswith("bfloat16") else 4
    nbytes = (n * k * bits // 8 + n * k // 8 + esize * m * (k + n))
    ops = 2.0 * m * n * k
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(dtype)[6:]] * 1e3
    plan = (quant.gemm_plan(m, n, k, bits, sms) if esize == 2
            else quant.f32_plan(m, n, k, sms))
    return dict(bytes=nbytes, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                plan=dataclasses.asdict(plan))


def child(tree: str, flags: list[str], probe: str | None, only: list[str],
          profile: bool = False, plans: bool = False) -> None:
    """Runs inside `tree`: times its kernels of the groups `only`, built
    with the extra nvcc `flags`, and prints one JSON line. Each B4/B5 row
    carries its plan, bytes and bound; a probe build of the bf16 body
    (`probe` "bf16") times bf16 x only and adds the single-step case, one
    of the f32 body ("f32") f32 x only."""
    turns.enter(tree)
    import torch

    from nemotron_tpu_torch import kernels
    from nemotron_tpu_torch.ops import quant

    kernels.NVCC_FLAGS = (*kernels.NVCC_FLAGS, *flags)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    rows = []
    if plans:
        rows = (plan_rows(torch, dev, rng, sms) + form_rows(torch, dev, rng,
                                                            sms)
                if "b4b5" in only else [])
        if "mel" in only:
            rows += mel_rows(torch, dev, rng, plans=True)
        print(json.dumps({"rows": rows}))
        return
    if "b1" in only or "b3" in only:
        rows += [r for r in attn_rows(torch, dev, rng, "b3" in only, profile)
                 if {"t1_attention": "b1", "t1_attention_block": "b3"}[
                     r["kernel"]] in only]
    forms = {"bf16": ((torch.bfloat16, BATCHES),),
             "f32": ((torch.float32, F32_BATCHES),)}.get(
                 probe, ((torch.bfloat16, BATCHES),
                         (torch.float32, F32_BATCHES)))
    for bits in ((8, 4) if "b4b5" in only else ()):
        qz = quant.quantize_q8 if bits == 8 else quant.quantize_q4
        fn = quant.linear_q8 if bits == 8 else quant.linear_q4
        deq = quant.dequantize if bits == 8 else quant.dequantize_q4
        for n, k in SHAPES + ((ONE_STEP,) if probe == "bf16" else ()):
            qt = qz((rng.standard_normal((n, k)) / np.sqrt(k)).astype(
                np.float32)).to(dev)
            for dtype, batches in forms:
                wt = deq(qt, dtype)  # [N, K] in x's type, once
                for m in batches:
                    x = torch.tensor(rng.standard_normal((m, k)).astype(
                        np.float32), device=dev).to(dtype)
                    row = dict(kernel=f"q{bits}_matmul", bits=bits,
                               dtype=str(dtype)[6:], m=m, n=n, k=k,
                               ms=cuda_ms(torch, lambda: fn(x, qt)),
                               dense_ms=cuda_ms(
                                   torch, lambda: torch.matmul(x, wt.T)),
                               **gemm_work(quant, bits, dtype, m, n, k, sms))
                    rows.append(row)
    if "mel" in only:
        rows += mel_rows(torch, dev, rng)
    if "tick" in only:
        rows += tick_rows(torch)
    if "e2e" in only:
        rows += e2e_rows(torch)
    print(json.dumps({"rows": rows}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="label=path, in the order to run")
    ap.add_argument("--probe", nargs="?", const="all",
                    choices=("all", "f32", "gemm", "large"),
                    help="also time measurement builds of B1 and B4/B5 "
                    "(all), of the f32 body only (f32), of B4/B5's bodies "
                    "without the deeper rings (gemm), or of the large-M "
                    "form only (large)")
    ap.add_argument("--only", action="append", choices=GROUPS,
                    help="kernel groups to time (default: all)")
    ap.add_argument("--profile", action="store_true",
                    help="also give B3's launches' device us (torch.profiler)")
    ap.add_argument("--plans", action="store_true",
                    help="also time the change's f32 B4 at every plan "
                    "ops/quant.py:f32_plan weighs (with b4b5) and B2 at "
                    "every tile of ops/mel_kernel.py:mel_plan (with mel)")
    ap.add_argument("--json", help="write every run's rows here as JSON")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--flag", action="append", default=[],
                    help=argparse.SUPPRESS)
    ap.add_argument("--child-probe", choices=("bf16", "f32"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = args.only or list(GROUPS)
    if args.child:
        child(args.child, args.flag, args.child_probe, only, args.profile,
              args.plans)
        return 0
    card = turns.card()
    print(card, flush=True)
    runs = [(t.split("=", 1)[0], t.split("=", 1)[1], None, None)
            for t in args.tree]
    change = next((r[1] for r in runs if r[0] == "change"), None)
    if args.probe == "all" and change and "b1" in only:
        runs += [(label, change, flags, ("b1",)) for label, flags in B1_PROBES]
    if args.probe in ("all", "gemm", "large") and change and "b4b5" in only:
        keep = {"all": lambda f: True,
                "gemm": lambda f: "STAGES" not in f and "LARGE" not in f,
                "large": lambda f: "LARGE" in f}[args.probe]
        runs += [(label, change, flags, ("b4b5",)) for label, flags in PROBES
                 if keep(str(flags))]
    if args.probe in ("all", "f32", "gemm") and change and (
            "b3" in only or "b4b5" in only):
        runs += [(label, change, flags, tuple(g for g in ("b3", "b4b5")
                                              if g in only))
                 for label, flags in F32_PROBES]
    if args.plans and change:
        runs.append(("plans", change, (), ()))
    out = []
    for label, path, flags, probe in runs:
        cmd = []
        if probe == ():  # the plan sweeps only
            cmd += ["--plans"] + [f"--only={g}" for g in only]
        elif probe is not None:  # a probe build times its groups
            cmd += [f"--only={g}" for g in probe]
            cmd += [f"--flag={f}" for f in flags]
            if "b4b5" in probe:
                cmd += ["--child-probe="
                        + ("f32" if "-DWQ_F32_PROBE" in str(flags)
                           else "bf16")]
            cmd += ["--profile"] if "b3" in probe and args.profile else []
        else:
            cmd += [f"--only={g}" for g in only]
            cmd += ["--profile"] if args.profile else []
        got = turns.run_child(__file__, label, path, cmd)
        if got is None:
            return 1
        out.append(dict(label=label, path=path, flags=list(flags or ()),
                        **got))
        for r in got["rows"]:
            if r["kernel"].endswith(" form"):
                parts = "".join(f"; {k} {v:.2f} us" for k, v in
                                r.get("launch_us", {}).items())
                print(f"{label}: q{r['bits']} {r.get('dtype', 'bfloat16')} "
                      f"M={r['m']} N={r['n']}"
                      f" K={r['k']} {r['form']}"
                      f"{' (chosen)' if r['chosen'] else ''}: "
                      f"{r['ms']:.4f} ms, rel err {r['rel_err']:.2e}{parts} "
                      f"({card})", flush=True)
                continue
            if r["kernel"] == "q8_matmul plan":
                print(f"{label}: q8 float32 M={r['m']} N={r['n']} K={r['k']}"
                      f" plan {r['bm']} x {r['splits']}"
                      f"{' (chosen)' if r['chosen'] else ''}: "
                      f"{r['ms']:.4f} ms ({card})", flush=True)
                continue
            if "bits" not in r:
                parts = "".join(f"; {k} {v:.2f} us" for k, v in
                                r.get("launch_us", {}).items())
                if "rfft_ms" in r:
                    parts += f", rfft {r['rfft_ms']:.4f} ms"
                if r.get("busy_ms") is not None:
                    parts += f", device busy {r['busy_ms']:.3f} ms"
                if "audio_s_per_s" in r:
                    parts += f", {r['audio_s_per_s']:.1f} audio-s/s"
                print(f"{label}: {r['kernel']} {r['case']}: {r['ms']:.4f} ms"
                      f"{parts} ({card})", flush=True)
                continue
            plan = " ".join(f"{k} {v}" for k, v in r["plan"].items())
            print(f"{label}: q{r['bits']} {r['dtype']} "
                  f"M={r['m']} N={r['n']} K={r['k']}: "
                  f"{r['ms']:.4f} ms, dense {r['dense_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}, share "
                  f"{r['bound_ms'] / r['ms']:.2f}), {r['bytes']} bytes; "
                  f"plan {plan} ({card})", flush=True)
    turns.write_json(args.json, card, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
