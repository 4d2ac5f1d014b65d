"""Masked in-place rewrites of K/V cache rows: the CUDA kernel
`csrc/kv_rows.cu` and its plain PyTorch version. It replaces no TPU
kernel: it carries the slack buffer's compaction and realign
(models/encoder.py) and the slot reset (streaming/state.py), which the JAX
package writes as XLA ops over every row (nemotron_tpu/models/encoder.py
compact_cache / realign_cache, nemotron_tpu/streaming/state.py
reset_slots).

A buffer is one tensor of a cache with its slots at axis 1 and its frames
at axis 3: dense [L, B, H, S, Dh], int8 codes [L, B, H, S, Dh] or a
QuantKV's scales [L, B, H, S] (`kvquant.kv_parts` gives them). For each
row (layer, slot, head) whose slot is set in the [B] bool `mask` (every
row when `mask` is None), in place:

    SHIFT: frames [lo, lo + lc) move to [0, lc)
    ROLL:  the S axis rolls by `shift` (torch.roll's sense)
    ZERO:  the row becomes 0

A CUDA tensor goes through the kernel (or the call raises): the mask is
read on the device, so nothing comes back to the host and the call can be
captured into a CUDA graph. A CPU tensor takes `kv_rows_ref_`, the JAX
package's formulation (slices, torch.roll, torch.where over every row).
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from .kvquant import kv_parts, on_parts

SHIFT, ROLL, ZERO = 0, 1, 2
MODES = {SHIFT: "shift", ROLL: "roll", ZERO: "zero"}
GROUP_SMEM = 48 * 1024  # a block stages at most this many bytes of rows
VECS = (16, 8, 4, 2, 1)  # the kernel's vector widths, in bytes


def _slot_mask(mask, buf):
    """[B] bool on buf's device, shaped to broadcast over buf's slots."""
    m = mask.to(device=buf.device, dtype=torch.bool)
    return m.reshape((1, -1) + (1,) * (buf.dim() - 2))


def kv_rows_ref_(buf, mode: int, mask=None, lo: int = 0, lc: int = 0,
                 shift: int = 0):
    """Plain PyTorch version, in place (returns buf)."""
    m = None if mask is None else _slot_mask(mask, buf)
    if mode == SHIFT:
        win = buf.narrow(3, lo, lc)
        head = buf.narrow(3, 0, lc)
        head.copy_(win.clone() if m is None else torch.where(m, win, head))
    elif mode == ROLL:
        rolled = torch.roll(buf, shift, dims=3)
        buf.copy_(rolled if m is None else torch.where(m, rolled, buf))
    elif mode == ZERO:
        if m is None:
            buf.zero_()
        else:
            buf.copy_(torch.where(m, torch.zeros_like(buf), buf))
    else:
        raise ValueError(f"kv_rows: unknown mode {mode}")
    return buf


def caches_rows_(k_cache, v_cache, mode: int, mask=None, tp=None, **kw):
    """kv_rows_ on every buffer of a K/V cache pair (dense, a QuantKV's
    codes and scales, each HeadShards part's; with tp, a params.TPGroup,
    each part's on its rank's stream, kvquant.on_parts), in place."""
    def rows(*caches):
        for buf in (t for c in caches for t in kv_parts(c)):
            kv_rows_(buf, mode, mask, **kw)

    on_parts(tp, rows, k_cache, v_cache)


@functools.lru_cache(maxsize=None)
def kv_rows_plan(heads: int, staged_row_bytes: int) -> int:
    """Heads per block: the most of a slot's heads (a divisor of `heads`)
    whose staged rows fit GROUP_SMEM, at least one (a row of up to the
    kernel's 227 KB then stages alone)."""
    return max([g for g in range(1, heads + 1)
                if heads % g == 0 and g * staged_row_bytes <= GROUP_SMEM],
               default=1)


def kv_rows_(buf, mode: int, mask=None, lo: int = 0, lc: int = 0,
             shift: int = 0):
    """The rewrite of the module docstring on one buffer, in place (kernel
    on CUDA). Returns buf."""
    if buf.dim() not in (4, 5):
        raise ValueError(f"kv_rows: buffer of {buf.dim()} dims, want "
                         f"[L, B, H, S] or [L, B, H, S, Dh]")
    n_l, b, h, s = buf.shape[:4]
    if mode == SHIFT and not (0 <= lo and 0 < lc and lo + lc <= s):
        raise ValueError(f"kv_rows: window [{lo}, {lo + lc}) outside S={s}")
    if mode == ROLL:
        shift %= s
    if mask is not None and tuple(mask.shape) != (b,):
        raise ValueError(f"kv_rows: mask {tuple(mask.shape)}, want ({b},)")
    if buf.device.type == "cpu":
        return kv_rows_ref_(buf, mode, mask, lo, lc, shift)
    if buf.device.type != "cuda":
        raise ValueError(f"kv_rows: unsupported device {buf.device}")
    if mode not in MODES:
        raise ValueError(f"kv_rows: unknown mode {mode}")
    if not buf.is_contiguous():
        raise ValueError("kv_rows: the buffer must be contiguous")
    if (mode == ROLL and shift == 0) or buf.numel() == 0:
        return buf
    if mask is not None:
        mask = mask.to(device=buf.device, dtype=torch.bool).contiguous()
    w = buf.element_size() * (buf.shape[4] if buf.dim() == 5 else 1)
    vec = next(v for v in VECS if w % v == 0 and buf.data_ptr() % v == 0)
    staged = {SHIFT: lc, ROLL: s, ZERO: 0}[mode] * w
    group = kv_rows_plan(h, staged)
    with torch.cuda.device(buf.device):  # a head shard's own card
        kernels.KV_ROWS.launch(
            "kv_rows", buf.data_ptr(),
            None if mask is None else mask.data_ptr(), n_l * b, b, h, group,
            s, w, vec, mode, lo, lc, shift)
    return buf
