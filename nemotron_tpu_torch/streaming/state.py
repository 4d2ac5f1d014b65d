"""Per-stream device-resident state for cache-aware streaming (port of
nemotron_tpu/streaming/state.py): the same fields, layouts and phase
semantics, so the two packages' states compare leaf by leaf.

`state_leaves` flattens a state in the JAX package's pytree order (the
dataclass fields in order, a `QuantKV` cache as q then s, the decode
state's four fields), the order of its snapshots and session checkpoints;
`state_from_leaves` is the inverse. `extract_slot` / `install_slot` move one
slot between a batched state on the device and a batch-1 state of numpy
leaves (live-stream migration).

On a mesh (parallel/mesh.py) a state is a `MeshState`: one StreamState per
dp shard, shard d holding global slots [d * b, (d + 1) * b) on its lead
device, and with tp its K/V caches as HeadShards over its tp devices.
`reset_slots`, `extract_slots`, `install_slot` and `state_leaves` take it
as they take a StreamState and see the logical state: its leaves are the
single device's (the shards' batches and heads in order), so a snapshot
from a mesh equals one from a single device, byte for byte, and installs
into either."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.decoder import DecodeState, init_decode_state
from ..ops.kv_rows import ZERO, caches_rows_
from ..ops.kvquant import HeadShards, QuantKV, is_quant, kv_parts, kv_zeros
from ..config import CacheConfig, Hparams

# Steady-state preprocessor tail: with the carry primed as [256 centre-pad
# zeros || first 96 pre-emphasized samples], every shift_samples block
# yields exactly shift_mel_frames mel frames.
PP_TAIL_LEN = 512 - 160  # n_fft - hop


@dataclasses.dataclass
class StreamState:
    k_cache: torch.Tensor      # [L, B, H, cache_buf_len, Dh] head-major
    v_cache: torch.Tensor      # ... or ops.kvquant.QuantKV (kv_int8)
    conv_cache: torch.Tensor   # [L, B, kernel-1, D]
    cache_valid: torch.Tensor  # [B] int32
    decode: DecodeState
    pp_tail: torch.Tensor      # [B, PP_TAIL_LEN] f32 pre-emphasized carry
    pp_last: torch.Tensor      # [B] f32 raw last sample
    mel_ov: torch.Tensor       # [B, pre_encode_cache_size, n_mels] f32


def init_stream_state(batch: int, hp: Hparams, cfg: CacheConfig,
                      dtype=torch.float32, *, device,
                      kv_int8: bool = False,
                      kv_devices=None) -> StreamState:
    """Zero state; kv_int8 allocates int8 QuantKV K/V caches. kv_devices
    (a dp shard's tp devices, more than one) allocates each K/V cache as
    HeadShards, H / len(kv_devices) heads on each."""
    L, D = hp.n_layers, hp.d_model
    n = len(kv_devices) if kv_devices else 1
    if hp.n_heads % n:
        raise ValueError(f"tp={n} does not divide n_heads={hp.n_heads}")
    kv_shape = (L, batch, hp.n_heads // n, cfg.cache_buf_len(hp), hp.d_head)
    f32 = dict(dtype=torch.float32, device=device)

    def one(dev):
        if kv_int8:
            return kv_zeros(kv_shape, device=dev)
        return torch.zeros(kv_shape, dtype=dtype, device=dev)

    def kv():
        if n == 1:
            return one(device)
        return HeadShards([one(dev) for dev in kv_devices])

    return StreamState(
        k_cache=kv(),
        v_cache=kv(),
        conv_cache=torch.zeros((L, batch, cfg.conv_kernel_size - 1, D),
                               dtype=dtype, device=device),
        cache_valid=torch.zeros((batch,), dtype=torch.int32, device=device),
        decode=init_decode_state(batch, hp, dtype=dtype, device=device),
        pp_tail=torch.zeros((batch, PP_TAIL_LEN), **f32),
        pp_last=torch.zeros((batch,), **f32),
        mel_ov=torch.zeros((batch, cfg.pre_encode_cache_size, cfg.n_mels),
                           **f32),
    )


@dataclasses.dataclass
class MeshState:
    """A stream batch over a mesh's dp shards: shards[d], a StreamState on
    shard d's devices, holds global slots [d * b, (d + 1) * b)."""
    shards: list

    @property
    def per_shard(self) -> int:
        return int(self.shards[0].cache_valid.shape[0])

    def locate(self, slot: int) -> tuple[int, int]:
        """Global slot -> (dp shard, slot within it)."""
        return divmod(int(slot), self.per_shard)

    @property
    def decode(self) -> DecodeState:
        """The logical decode state, gathered on shard 0's device (a copy,
        for reading)."""
        dev = self.shards[0].cache_valid.device
        return DecodeState(*(
            torch.cat([getattr(s.decode, f.name).to(dev)
                       for s in self.shards])
            for f in dataclasses.fields(DecodeState)))


def reset_slots(state, mask, hp: Hparams, tp=None):
    """Zero the slots where mask[b] is True (stream join), in place: the
    K/V caches by masked row rewrites (ops/kv_rows.py, ZERO: on the card
    one kernel launch per buffer; with tp, a params.TPGroup, each
    HeadShards part's on its rank's stream, kvquant.on_parts), every other
    leaf by a masked fill (JAX state.py's jnp.where, in place). The mask
    stays on the device: nothing is read back to the host, so the reset
    runs inside a CUDA graph."""
    if isinstance(state, MeshState):
        mask = np.asarray(mask)
        b = state.per_shard
        for d, shard in enumerate(state.shards):
            reset_slots(shard, mask[d * b:(d + 1) * b], hp)
        return state
    m = torch.as_tensor(mask).to(device=state.cache_valid.device,
                                 dtype=torch.bool)
    caches_rows_(state.k_cache, state.v_cache, ZERO, m, tp)
    state.conv_cache.masked_fill_(m[None, :, None, None], 0)
    for buf in (state.cache_valid, state.decode.h, state.decode.c,
                state.decode.frame_offset, state.pp_tail, state.pp_last,
                state.mel_ov):
        buf.masked_fill_(m.reshape((-1,) + (1,) * (buf.dim() - 1)), 0)
    state.decode.prev_token.masked_fill_(m, hp.blank_id)
    return state


def prime_frontend(state: StreamState, mask, tails, lasts) -> StreamState:
    """Install per-slot frontend carries (slot join: tail = 256 centre-pad
    zeros + the stream's first 96 pre-emphasized samples, so every later
    shift_samples block yields exactly shift_mel_frames frames), in
    place; the mask stays on the device."""
    m = mask.to(torch.bool)
    state.pp_tail.copy_(torch.where(m[:, None], tails, state.pp_tail))
    state.pp_last.copy_(torch.where(m, lasts, state.pp_last))
    return state


def write_back(dst: StreamState, src: StreamState) -> StreamState:
    """Copy every leaf of `src` that is not already `dst`'s own tensor
    into `dst`'s storage and return `dst`: a tick body ends with it, so a
    state's storage stays fixed across ticks (the JAX package donates the
    state to its compiled tick; a captured CUDA graph replays on fixed
    addresses)."""
    for d, s in zip(state_tensors(dst), state_tensors(src)):
        if s is not d:
            d.copy_(s)
    return dst


def state_tensors(state) -> list:
    """Every tensor a state owns, in state_leaves order (a QuantKV cache's
    codes and scales, a HeadShards cache's parts; of a MeshState, each
    shard's in turn): what a captured tick reads and writes. Of another
    graphed body's state (graphs.py): a dataclass's fields in order (the
    offline decode's DecodeCarry), or the tensors of a tuple (`()` for a
    body with no state, the diarize nets)."""
    if isinstance(state, MeshState):
        return [t for s in state.shards for t in state_tensors(s)]
    if isinstance(state, tuple):
        return list(state)
    if not isinstance(state, StreamState):
        return [getattr(state, f.name) for f in dataclasses.fields(state)]
    return [t for pieces in _leaf_pieces(state) for t in pieces]


# fields of StreamState with the batch at axis 1 (the caches); the others
# carry it at axis 0
_BATCH_AXIS1 = ("k_cache", "v_cache", "conv_cache")


def _leaf_pieces(state: StreamState) -> list[list]:
    """Each leaf of the JAX package's `jax.tree.leaves(StreamState)` order
    as its pieces: one tensor, or a HeadShards cache's parts' tensors,
    which split the leaf on its head axis (2)."""
    out = []
    for f in dataclasses.fields(StreamState):
        v = getattr(state, f.name)
        if f.name == "decode":
            out.extend([getattr(v, g.name)] for g in dataclasses.fields(v))
        elif isinstance(v, HeadShards):
            out.extend(map(list, zip(*(kv_parts(p) for p in v.parts))))
        else:
            out.extend([t] for t in kv_parts(v))
    return out


def state_leaves(state) -> list:
    """The leaves in the JAX package's `jax.tree.leaves(StreamState)`
    order. A StreamState's own tensors; of a MeshState, or of head-sharded
    caches, the logical leaves gathered on the lead device (copies)."""
    if isinstance(state, MeshState):
        dev = state.shards[0].cache_valid.device
        per = [state_leaves(s) for s in state.shards]
        return [torch.cat([x.to(dev) for x in xs], dim=ax)
                for xs, ax in zip(zip(*per), _leaf_axes(state.shards[0]))]
    return [p[0] if len(p) == 1 else
            torch.cat([x.to(p[0].device) for x in p], dim=2)
            for p in _leaf_pieces(state)]


def state_from_leaves(leaves, kv_int8: bool) -> StreamState:
    """Inverse of state_leaves; kv_int8 says whether each K/V cache is two
    leaves (a QuantKV's q and s) or one."""
    it = iter(leaves)
    kw = {}
    for f in dataclasses.fields(StreamState):
        if f.name == "decode":
            kw[f.name] = DecodeState(*(next(it) for _ in range(4)))
        elif f.name in ("k_cache", "v_cache") and kv_int8:
            kw[f.name] = QuantKV(next(it), next(it))
        else:
            kw[f.name] = next(it)
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves too many for a StreamState "
                         f"(kv_int8={kv_int8})")
    return StreamState(**kw)


def _leaf_axes(state: StreamState) -> list[int]:
    """The batch axis of each leaf of state_leaves(state)."""
    out = []
    for f in dataclasses.fields(StreamState):
        v = getattr(state, f.name)
        if isinstance(v, HeadShards):
            v = v.parts[0]
        n = 4 if f.name == "decode" else len(kv_parts(v))
        out.extend([1 if f.name in _BATCH_AXIS1 else 0] * n)
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bfloat16 as its uint16 bit pattern
    (the only uint16 leaves of a state), as the JAX package's snapshots
    store it."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of to_numpy into `dtype`: a uint16 array is a bfloat16 bit
    pattern; anything else converts by value."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            dtype)
    return torch.from_numpy(a).to(dtype)


def extract_slot(state: StreamState, idx: int) -> StreamState:
    """Slot `idx` of a batched state as a batch-1 StreamState of numpy
    leaves (the basis of a live-stream export): the caches carry the batch
    at axis 1, everything else at axis 0; a QuantKV cache yields its q and
    its s; bf16 leaves come back as uint16 bit patterns (to_numpy)."""
    return extract_slots(state, [idx])[0]


def extract_slots(state, idxs) -> list[StreamState]:
    """extract_slot of each slot in `idxs`, with one gather on the device
    and one device-to-host copy per leaf for all of them (the snapshots'
    leaves are views of those copies). Of a MeshState, each shard's slots
    from that shard; head shards' pieces joined on the host."""
    idxs = list(idxs)
    if isinstance(state, MeshState):
        by = {}
        for j, i in enumerate(idxs):
            d, local = state.locate(i)
            by.setdefault(d, []).append((j, local))
        out = [None] * len(idxs)
        for d, items in by.items():
            snaps = extract_slots(state.shards[d], [lo for _, lo in items])
            for (j, _), snap in zip(items, snaps):
                out[j] = snap
        return out
    rows = torch.as_tensor(idxs, dtype=torch.long,
                           device=state.cache_valid.device)
    host = []
    for pieces, ax in zip(_leaf_pieces(state), _leaf_axes(state)):
        parts = [to_numpy(t.index_select(ax, rows.to(t.device)))
                 for t in pieces]
        host.append((parts[0] if len(parts) == 1
                     else np.concatenate(parts, axis=2), ax))
    quant = is_quant(state.k_cache)
    return [state_from_leaves(
        [h[(slice(None),) * ax + (slice(j, j + 1),)] for h, ax in host],
        quant) for j in range(len(rows))]


def install_slot(state, idx: int, snap: StreamState):
    """Write a batch-1 snapshot (from extract_slot) into slot `idx`, in
    place. Every leaf's shape is checked against the slot's before any is
    written: a broadcasting copy would silently install a foreign-shaped
    snapshot (other Hparams, CacheConfig or kv-int8 mode), and a failure
    leaves the state untouched. Into a MeshState, the slot's shard takes
    it; head-sharded leaves are split on the host."""
    if isinstance(state, MeshState):
        d, local = state.locate(idx)
        install_slot(state.shards[d], local, snap)
        return state
    dst = _leaf_pieces(state)
    src = state_leaves(snap)
    if len(src) != len(dst):
        raise ValueError(f"snapshot has {len(src)} leaves, the state "
                         f"{len(dst)} (mismatched kv-int8 mode?)")
    axes = _leaf_axes(state)
    for d, s, ax in zip(dst, src, axes):
        want = list(d[0].shape)
        if len(d) > 1:  # head shards: the heads of all of them
            want[2] = sum(t.shape[2] for t in d)
        want[ax] = 1
        if tuple(np.shape(s)) != tuple(want):
            raise ValueError(
                f"snapshot leaf shape {tuple(np.shape(s))} != expected "
                f"{tuple(want)} (mismatched Hparams/CacheConfig?)")
    for d, s, ax in zip(dst, src, axes):
        s = np.asarray(s)
        if len(d) > 1:  # head shards: each its heads
            bounds = np.cumsum([0] + [t.shape[2] for t in d])
            parts = [s[:, :, lo:hi] for lo, hi in zip(bounds, bounds[1:])]
        else:
            parts = [s]
        for t, part in zip(d, parts):
            t.narrow(ax, idx, 1).copy_(from_numpy(part, t.dtype))
    return state
