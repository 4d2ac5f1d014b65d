"""Weight-only Q8_0 / Q4_0 linears: the CUDA kernels `csrc/q8_matmul.cu`
(B4) and `csrc/q4_matmul.cu` (B5) and their plain PyTorch versions (port of
nemotron_tpu/ops/quant.py). With bf16 activations `gemm_plan` picks the
form by shape: below LARGE_MIN_M rows of x the Hopper body
`csrc/wq_gemm_sm90.cuh` on the plan of `swap_plan` (batch tiles, split-K),
which sizes the f32 workspace of the splits; from there the large-M form
`csrc/wq_gemm_large.cuh` on the plan of `large_plan` (the weight
dequantized once into bf16 scratch, then a persistent wgmma GEMM). With
f32 activations they run the FFMA body `csrc/wq_matmul.cuh` on the plan
of `f32_plan`, whose splits the kernel sums itself (`f32_scratch`).

A Q8_0 weight is (w_i8 [..., out, in] int8, scales [..., out, in/32] f32):
element (n, k) is w_i8[n, k] * scales[n, k // 32]. A Q4_0 weight keeps the
JAX package's half-split packing: w_packed [..., out, in/2] uint8 holds
original column k < in/2 in the low nibble of packed column k and column
k >= in/2 in the high nibble of packed column k - in/2; its value is
(nibble - 8) * scales[n, k // 32]. Both accept a leading [L] axis and index
by layer.

The plain versions dequantize to x's dtype and call F.linear, as the JAX
package's default `linear_q8_xla` / `linear_q4_xla` do. A CUDA weight goes
through its kernel (or the call raises); a CPU weight takes the plain
version. The quantizers run in numpy, so both packages produce the same
bits from the same f32 weights.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels

QBLOCK = 32


@dataclasses.dataclass
class QuantizedTensor:
    w_i8: torch.Tensor    # [..., out, in] int8
    scales: torch.Tensor  # [..., out, in // 32] f32

    def __getitem__(self, i):
        return QuantizedTensor(self.w_i8[i], self.scales[i])

    def to(self, device):
        return QuantizedTensor(self.w_i8.to(device), self.scales.to(device))


@dataclasses.dataclass
class QuantizedTensor4:
    w_packed: torch.Tensor  # [..., out, in // 2] uint8, half-split nibbles
    scales: torch.Tensor    # [..., out, in // 32] f32, original-order blocks

    def __getitem__(self, i):
        return QuantizedTensor4(self.w_packed[i], self.scales[i])

    def to(self, device):
        return QuantizedTensor4(self.w_packed.to(device),
                                self.scales.to(device))


def is_quantized(w) -> bool:
    return isinstance(w, (QuantizedTensor, QuantizedTensor4))


def _blocks(w, multiple: int):
    w = np.asarray(w, np.float32)
    if w.shape[-1] % multiple:
        raise ValueError(f"input width {w.shape[-1]} is not a multiple of "
                         f"{multiple}")
    blocks = w.reshape(*w.shape[:-1], w.shape[-1] // QBLOCK, QBLOCK)
    return w.shape, np.abs(blocks).max(axis=-1), blocks


def quantize_q8(w) -> QuantizedTensor:
    """Quantize [..., out, in] to Q8_0 blocks (amax/127 per 32 inputs)."""
    shape, amax, blocks = _blocks(w, QBLOCK)
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(blocks / scales[..., None]), -127, 127).astype(np.int8)
    return QuantizedTensor(torch.from_numpy(q.reshape(shape)),
                           torch.from_numpy(scales))


def from_gguf_q8(raw: bytes, out: int, inp: int) -> QuantizedTensor:
    """A QuantizedTensor straight from a raw GGUF Q8_0 payload."""
    block = np.dtype([("scale", np.float16), ("q", np.int8, QBLOCK)])
    arr = np.frombuffer(raw, dtype=block, count=out * inp // QBLOCK)
    return QuantizedTensor(
        torch.from_numpy(arr["q"].reshape(out, inp).copy()),
        torch.from_numpy(arr["scale"].astype(np.float32).reshape(
            out, inp // QBLOCK)))


def dequantize(qt: QuantizedTensor, dtype=torch.float32):
    scales = qt.scales.repeat_interleave(QBLOCK, dim=-1)
    return (qt.w_i8.float() * scales).to(dtype)


def _pack_half_split(qu: np.ndarray) -> np.ndarray:
    """[..., out, in] nibble values (0..15) -> half-split packed bytes."""
    half = qu.shape[-1] // 2
    return ((qu[..., :half] & 0x0F) | (qu[..., half:] << 4)).astype(np.uint8)


def quantize_q4(w) -> QuantizedTensor4:
    """Quantize [..., out, in] to Q4_0 semantics (amax/7 per 32-block,
    values in [-8, 7] stored as nibble + 8); in % 64 == 0."""
    shape, amax, blocks = _blocks(w, 2 * QBLOCK)
    scales = np.where(amax > 0, amax / 7.0, 1.0).astype(np.float32)
    q = np.clip(np.round(blocks / scales[..., None]), -8, 7).astype(np.int8)
    qu = (q + 8).astype(np.uint8).reshape(shape)
    return QuantizedTensor4(torch.from_numpy(_pack_half_split(qu)),
                            torch.from_numpy(scales))


def from_gguf_q4(raw: bytes, out: int, inp: int) -> QuantizedTensor4:
    """A QuantizedTensor4 from a raw GGUF Q4_0 payload (repacked from GGUF's
    per-block low/high nibble order to the half-split layout)."""
    block = np.dtype([("scale", np.float16), ("q", np.uint8, QBLOCK // 2)])
    arr = np.frombuffer(raw, dtype=block, count=out * inp // QBLOCK)
    qu = np.concatenate([arr["q"] & 0x0F, arr["q"] >> 4], axis=1)
    return QuantizedTensor4(
        torch.from_numpy(_pack_half_split(qu.reshape(out, inp))),
        torch.from_numpy(arr["scale"].astype(np.float32).reshape(
            out, inp // QBLOCK)))


def dequantize_q4(qt: QuantizedTensor4, dtype=torch.float32):
    w32 = qt.w_packed.to(torch.int32)
    vals = torch.cat([(w32 & 0x0F) - 8, (w32 >> 4) - 8], dim=-1).float()
    scales = qt.scales.repeat_interleave(QBLOCK, dim=-1)
    return (vals * scales).to(dtype)


def linear_q8_ref(x, qt: QuantizedTensor):
    """Plain version: dequantize to x.dtype, then x @ w.T."""
    return F.linear(x, dequantize(qt, x.dtype))


def linear_q4_ref(x, qt: QuantizedTensor4):
    return F.linear(x, dequantize_q4(qt, x.dtype))


_SYMBOL = {torch.float32: "f32", torch.bfloat16: "bf16"}

# The bf16 body of B4 / B5 (csrc/wq_gemm_sm90.cuh): blocks of GEMM_ROWS
# weight rows (two warpgroups of 64), pipeline steps of GEMM_STEP code
# columns (Q4_0: packed columns, two K ranges each), the wgmma widths a
# block's batch rows are padded to (at most 128 rows per block). The ring's
# stages are the launcher's choice, from the card's shared memory.
GEMM_ROWS = 128
GEMM_STEP = 64
GEMM_M_TILES = (16, 32, 48, 64, 80, 96, 112, 128)
GEMM_MIN_ROWS = 64  # the batch is cut no finer to fill the SMs
GEMM_MIN_STEPS = 2  # least steps per split (fewer: partials outweigh codes)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How the bf16 body covers one call: batch rows padded to m_tile per
    block (tiles_m blocks along M), `steps` pipeline steps of GEMM_STEP
    code columns cut into `splits` runs of steps_per (the last may be
    shorter; none is empty)."""
    m_tile: int
    tiles_m: int
    splits: int
    steps: int
    steps_per: int

    def split_columns(self, k: int, bits: int) -> list[np.ndarray]:
        """The original K columns that each split sums, in split order."""
        kc = k if bits == 8 else k // 2
        out = []
        for z in range(self.splits):
            lo = z * self.steps_per * GEMM_STEP
            cols = np.arange(lo, min(kc, lo + self.steps_per * GEMM_STEP))
            out.append(cols if bits == 8 else np.concatenate([cols,
                                                              cols + kc]))
        return out


def swap_plan(m: int, n: int, k: int, bits: int, sms: int) -> GemmPlan:
    """The M <= 256 form of one bf16 B4 (bits 8) / B5 (bits 4) call on a
    card with `sms` SMs, toward one block per SM: the batch is cut into
    tiles of at most 128 rows, and into more tiles of at least 64 rows
    while the blocks still fit the SMs (a second read of a code tile comes
    from L2; f32 partials of split-K cost more); then K is split where SMs
    are still idle, at least GEMM_MIN_STEPS steps per split."""
    blocks_n = -(-n // GEMM_ROWS)
    tiles_m = -(-m // GEMM_M_TILES[-1])
    while tiles_m < m // GEMM_MIN_ROWS and blocks_n * (tiles_m + 1) <= sms:
        tiles_m += 1
    m_tile = min(t for t in GEMM_M_TILES if t >= -(-m // tiles_m))
    tiles_m = -(-m // m_tile)
    steps = -(-(k if bits == 8 else k // 2) // GEMM_STEP)
    want = max(1, sms // (blocks_n * tiles_m))
    steps_per = min(steps, max(GEMM_MIN_STEPS, -(-steps // want)))
    return GemmPlan(m_tile, tiles_m, -(-steps // steps_per), steps, steps_per)


# The large-M form of the bf16 body (csrc/wq_gemm_large.cuh): the weight
# dequantized once to bf16, then persistent blocks (at most one per SM)
# over output tiles of LARGE_ROWS x rows by one of LARGE_BN weight rows, K
# in steps of GEMM_STEP columns.
LARGE_ROWS = 128
LARGE_BN = (256, 128)
# gemm_plan's crossover: the large-M form from this many rows of x on
# (tools/gemm_turns.py --plans, NVIDIA H100 80GB HBM3: at 512 rows the M <=
# 256 form is as fast or faster at every (N, K); at 769 the large-M form
# wins at every Q8_0 (N, K) and loses at three of Q4_0's; from 1,792 it
# wins at all but Q4_0's (1024, 4096))
LARGE_MIN_M = 1024
# the cost of a 128 x bn tile in units of its bn weight rows, plus this
# many for its fixed cost (fill, epilogue): a 128-wide tile measured 0.72
# of a 256-wide one's time
LARGE_TILE_FIXED = 200


@dataclasses.dataclass(frozen=True)
class LargePlan:
    """How the large-M form covers one call: tiles_m x tiles_n output tiles
    of LARGE_ROWS x bn, walked by `blocks` persistent blocks (block b takes
    tiles b, b + blocks, ...; tile t at x rows (t // tiles_n) * LARGE_ROWS
    and weight rows (t % tiles_n) * bn), each over all `steps` steps of
    GEMM_STEP columns of K: no split of K."""
    bn: int
    tiles_m: int
    tiles_n: int
    blocks: int
    steps: int

    @property
    def tiles(self) -> int:
        return self.tiles_m * self.tiles_n

    def block_tiles(self, b: int) -> list[tuple[int, int]]:
        """(first x row, first weight row) of each tile of block b, in the
        order the block takes them."""
        return [((t // self.tiles_n) * LARGE_ROWS,
                 (t % self.tiles_n) * self.bn)
                for t in range(b, self.tiles, self.blocks)]


def _large_cost(m: int, n: int, bn: int, sms: int) -> float:
    tiles = -(-m // LARGE_ROWS) * -(-n // bn)
    return -(-tiles // sms) * (bn + LARGE_TILE_FIXED)


def large_plan(m: int, n: int, k: int, sms: int,
               bn: int | None = None) -> LargePlan:
    """The large-M form's plan (of `bn` weight rows per tile, or of the
    LARGE_BN width of least modelled time: waves of one tile per SM, each
    tile's weight rows plus LARGE_TILE_FIXED; ties to the wider tile), one
    block per SM or per tile, the fewer."""
    if bn is None:
        bn = min(LARGE_BN, key=lambda b: (_large_cost(m, n, b, sms), -b))
    tiles_m, tiles_n = -(-m // LARGE_ROWS), -(-n // bn)
    return LargePlan(bn, tiles_m, tiles_n, min(sms, tiles_m * tiles_n),
                     -(-k // GEMM_STEP))


@functools.lru_cache(maxsize=None)
def gemm_plan(m: int, n: int, k: int, bits: int, sms: int):
    """The plan of one bf16 B4 (bits 8) / B5 (bits 4) call on a card with
    `sms` SMs, by shape alone: from LARGE_MIN_M rows of x on (N % 8 == 0)
    the large-M form (large_plan), below them the M <= 256 form
    (swap_plan)."""
    if m >= LARGE_MIN_M and n % 8 == 0:
        return large_plan(m, n, k, sms)
    return swap_plan(m, n, k, bits, sms)


# The f32 body (csrc/wq_matmul.cuh): blocks of F32_ROWS weight rows (output
# columns) by one of F32_M_TILES batch rows, pipeline steps of F32_STEP K
# columns. One block per SM (its registers and two-stage ring).
F32_ROWS = 128
F32_STEP = 64
F32_M_TILES = (64, 128)


@dataclasses.dataclass(frozen=True)
class F32Plan:
    """How the f32 body covers one call: batch tiles of bm rows (tiles_m of
    them) by tiles_n tiles of F32_ROWS weight rows, `steps` steps of
    F32_STEP K columns cut into `splits` runs of steps_per (the last may be
    shorter; none is empty)."""
    bm: int
    tiles_m: int
    tiles_n: int
    splits: int
    steps: int
    steps_per: int

    @property
    def tiles(self) -> int:
        return self.tiles_m * self.tiles_n

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def split_columns(self, k: int) -> list[np.ndarray]:
        """The K columns that each split sums, in split order."""
        return [np.arange(z * self.steps_per * F32_STEP,
                          min(k, (z + 1) * self.steps_per * F32_STEP))
                for z in range(self.splits)]


# The plan's cost model, fitted to the body's times over (batch tile,
# splits) at the encoder's shapes (tools/gemm_turns.py --plans, NVIDIA
# H100 80GB HBM3): a block's time is its steps x its batch rows (64-row
# tiles F32_COST_64 dearer per row: 4 x 8 outputs per thread; where the
# tiles take more than one wave of the SMs, as at the right-context and
# offline rows, F32_COST_64_WAVES, fitted at M = 1,792 to 16,384), and each
# extra split adds F32_COST_SPLIT (in 128-row step units) for its
# partial's write and read.
F32_COST_64 = 1.1
F32_COST_64_WAVES = 1.25
F32_COST_SPLIT = 11.7
F32_MAX_SPLITS = 16


def _f32_cost(m: int, n: int, steps: int, bm: int, steps_per: int,
              sms: int) -> float:
    tiles = -(-m // bm) * -(-n // F32_ROWS)
    splits = -(-steps // steps_per)
    waves = -(-tiles // sms)  # splits only where the tiles leave SMs
    per_row = 1.0 if bm != 64 else (F32_COST_64 if waves == 1
                                     else F32_COST_64_WAVES)
    return (waves * steps_per * bm * per_row
            + F32_COST_SPLIT * (splits - 1) * bm / 128)


@functools.lru_cache(maxsize=None)
def f32_plan(m: int, n: int, k: int, sms: int,
             max_splits: int | None = None) -> F32Plan:
    """The plan of one f32 call of the FFMA body (B4, B5, B3's projections)
    on a card with `sms` SMs: among the batch tiles (F32_M_TILES) and K
    splits (at most `max_splits`, or F32_MAX_SPLITS) that keep the blocks
    within one wave of one block per SM (or split nothing where the tiles
    alone exceed it), the one of least modelled time (_f32_cost); ties go
    to fewer splits, then to the larger tile."""
    steps = -(-k // F32_STEP)
    cap = min(steps, max_splits or F32_MAX_SPLITS, F32_MAX_SPLITS)
    best = None
    for bm in sorted(F32_M_TILES, reverse=True):
        tiles = -(-m // bm) * -(-n // F32_ROWS)
        for want in range(1, cap + 1):
            steps_per = -(-steps // want)
            splits = -(-steps // steps_per)
            if splits != want or tiles * splits > max(sms, tiles):
                continue  # a smaller want's plan, or past one wave
            key = (_f32_cost(m, n, steps, bm, steps_per, sms), splits, -bm)
            if best is None or key < best[0]:
                best = (key, bm, steps_per, splits)
    _, bm, steps_per, splits = best
    return F32Plan(bm, -(-m // bm), -(-n // F32_ROWS), splits, steps,
                   steps_per)


_COUNTERS: dict = {}
_RETIRED: list = []  # grown-out counter buffers a CUDA graph may still use


def f32_scratch(plan: F32Plan, device):
    """The workspace of a split f32 call, [splits, tiles, bm * F32_ROWS]
    f32 partials, and the per-tile arrival counters its last block reads
    and resets to 0: one zeroed int32 buffer per (device, stream), made
    once and grown when a call needs more tiles (stream order keeps a call
    from seeing another's counts; a grown-out buffer stays allocated, as
    a captured tick keeps its address). Returns (workspace, counters),
    both None without a split."""
    if plan.splits == 1:
        return None, None
    ws = torch.empty((plan.splits, plan.tiles, plan.bm * F32_ROWS),
                     dtype=torch.float32, device=device)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < plan.tiles:
        if cnt is not None:
            _RETIRED.append(cnt)
        cnt = torch.zeros(max(plan.tiles, 1024), dtype=torch.int32,
                          device=device)
        _COUNTERS[key] = cnt
    return ws, cnt


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


_SMS: dict = {}


def _sm_count(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _launch(kernel, prefix, x, w, scales, n, k, k_multiple, bits):
    """Shared wrapper of B4 / B5: checks, then one launch over x [M, K]
    (bf16: on the plan of gemm_plan, the M <= 256 form with its f32
    workspace or the large-M form with its bf16 weight scratch; f32: on
    the plan of f32_plan, with its workspace and tile counters)."""
    name = kernel.name
    if x.dtype not in _SYMBOL:
        raise ValueError(f"{name}: unsupported activation dtype {x.dtype}")
    if k % k_multiple:
        raise ValueError(f"{name}: K={k} is not a multiple of {k_multiple}")
    if x.shape[-1] != k:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match K={k}")
    if w.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"{name}: weights must be 2-D (index the layer first)")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (n, k // QBLOCK):
        raise ValueError(f"{name}: scales {tuple(scales.shape)} "
                         f"{scales.dtype}, want {(n, k // QBLOCK)} float32")
    for t in (w, scales):
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: weights must be contiguous")
    if w.data_ptr() % 16:  # the bf16 body reads the codes through TMA
        raise ValueError(f"{name}: weight codes are not 16-byte aligned")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:  # the kernel reads x in 16-byte vectors
        x2 = x2.clone()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if not m:
        return out.reshape(*lead, n)
    ptrs = (x2.data_ptr(), w.data_ptr(), scales.data_ptr(), out.data_ptr())
    if x.dtype == torch.float32:
        plan = f32_plan(m, n, k, _sm_count(x.device))
        ws, cnt = f32_scratch(plan, x.device)
        kernel.launch(f"{prefix}_f32", *ptrs, _ptr(ws), _ptr(cnt), m, n, k,
                      plan.bm, plan.splits, plan.steps_per)
    else:
        plan = gemm_plan(m, n, k, bits, _sm_count(x.device))
        if isinstance(plan, LargePlan):
            wbuf = torch.empty((n, k), dtype=torch.bfloat16, device=x.device)
            kernel.launch(f"{prefix}_bf16_large", *ptrs, wbuf.data_ptr(), m,
                          n, k, plan.bn, plan.blocks)
            return out.reshape(*lead, n)
        ws = (torch.empty((plan.splits, m, n), dtype=torch.float32,
                          device=x.device) if plan.splits > 1 else None)
        kernel.launch(f"{prefix}_bf16", *ptrs,
                      0 if ws is None else ws.data_ptr(), m, n, k,
                      plan.m_tile, plan.splits, plan.steps_per)
    return out.reshape(*lead, n)


def linear_q8(x, qt: QuantizedTensor):
    """x @ dequantize(qt).T: kernel B4 on CUDA, the plain version on CPU."""
    if qt.w_i8.device.type == "cpu":
        return linear_q8_ref(x, qt)
    if qt.w_i8.device.type != "cuda":
        raise ValueError(f"linear_q8: unsupported device {qt.w_i8.device}")
    if qt.w_i8.dtype != torch.int8:
        raise ValueError(f"linear_q8: weights are {qt.w_i8.dtype}, want int8")
    n, k = qt.w_i8.shape[-2:]
    return _launch(kernels.Q8_MATMUL, "q8_matmul", x, qt.w_i8, qt.scales,
                   n, k, QBLOCK, 8)


def linear_q4(x, qt: QuantizedTensor4):
    """x @ dequantize_q4(qt).T: kernel B5 on CUDA, the plain version on CPU."""
    if qt.w_packed.device.type == "cpu":
        return linear_q4_ref(x, qt)
    if qt.w_packed.device.type != "cuda":
        raise ValueError(f"linear_q4: unsupported device {qt.w_packed.device}")
    if qt.w_packed.dtype != torch.uint8:
        raise ValueError(
            f"linear_q4: weights are {qt.w_packed.dtype}, want uint8")
    n, k = qt.w_packed.shape[-2], qt.w_packed.shape[-1] * 2
    return _launch(kernels.Q4_MATMUL, "q4_matmul", x, qt.w_packed, qt.scales,
                   n, k, 2 * QBLOCK, 4)
