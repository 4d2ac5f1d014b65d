"""Device mesh for multi-device serving (port of nemotron_tpu/parallel/mesh.py).

The model fits one card, so the first scale axis is data parallel over
concurrent streams ('dp'): the stream batch splits into n_dp contiguous
slices, shard d holding global slots [d * B/n_dp, (d + 1) * B/n_dp), and
each shard runs the whole tick on its slice. An optional 'tp' axis splits
the large layer matrices within a shard Megatron-style (params.TP_SPLIT,
the JAX package's table): each tp device computes its heads' attention
and its slice of each FFN, and the partial products of the out projection
and of each FFN's w2 are summed on the shard's lead device
(models/encoder.py). The JAX package gets the same from GSPMD and its
shardings; here one engine thread ticks every shard in turn, launching on
each device's current stream, with no torch.distributed process group.

A `Mesh` is an [n_dp, n_tp] grid of torch.device. `make_mesh` takes the
first n_dp * n_tp CUDA cards, or an explicit device list, which may
repeat a device: ["cpu"] * n is the counterpart of the JAX package's
virtual CPU devices, [cuda:0] * n puts every shard on one card.
`ASRModel.shard(mesh)` places a model on a mesh (api.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.kvquant import HeadShards, QuantKV, is_quant
from ..params import (TP_SPLIT, ModelParams, TPGroup, device_of, tp_params,
                      upload)
from ..streaming.state import (MeshState, StreamState, extract_slots,
                               install_slot)

TP_OUT = (None, "tp", None)  # (L, sharded out, in)
TP_IN = (None, None, "tp")   # (L, out, sharded in)
REPLICATED = ()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An [n_dp, n_tp] grid of devices with the axis names 'dp' and 'tp'."""
    devices: tuple  # devices[d][t]: dp shard d's t-th tp device
    axis_names: tuple = ("dp", "tp")

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "tp": len(self.devices[0])}

    def __str__(self) -> str:
        flat = [str(d) for row in self.devices for d in row]
        where = (f"{flat[0]} x{len(flat)}" if len(set(flat)) == 1
                 else ",".join(flat))
        return f"dp={self.shape['dp']}xtp={self.shape['tp']}@{where}"


def make_mesh(n_dp: int | None = None, n_tp: int = 1, devices=None) -> Mesh:
    """The first n_dp * n_tp of `devices` (default: every CUDA card) as an
    [n_dp, n_tp] grid; n_dp None takes as many as the devices fill. Too few
    devices raise, as the JAX package's reshape does."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass "
                               "devices=['cpu'] * n to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [device_of(d) for d in devices]
    if n_dp is None:
        n_dp = len(devices) // n_tp
    if n_dp < 1 or n_tp < 1 or n_dp * n_tp > len(devices):
        raise ValueError(f"a dp={n_dp} x tp={n_tp} mesh needs "
                         f"{n_dp * n_tp} devices, {len(devices)} given")
    return Mesh(tuple(tuple(devices[d * n_tp:(d + 1) * n_tp])
                      for d in range(n_dp)))


def param_shardings(params: ModelParams, mesh: Mesh) -> ModelParams:
    """The spec of every parameter as a tuple of mesh axes per array axis
    (the JAX package's PartitionSpecs as tuples): replicated () over 'dp',
    the TP_SPLIT layer fields split over 'tp'. A quantized field's spec
    holds for its codes and its scales alike."""

    def specs(obj):
        if obj is None:
            return None
        if not dataclasses.is_dataclass(obj) or hasattr(obj, "scales"):
            return REPLICATED
        return dataclasses.replace(obj, **{
            f.name: specs(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})

    out = specs(params)
    out.layers = dataclasses.replace(out.layers, **{
        name: TP_OUT if axis == 1 else TP_IN
        for name, axis in TP_SPLIT.items()})
    return out


def state_shardings(state: StreamState, mesh: Mesh) -> StreamState:
    """The stream state's specs: split over 'dp' on the batch axis (axis 1
    of the [L, B, ...] caches, axis 0 of the decode state and counters)."""

    def spec(name, v):
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{
                f.name: spec(name, getattr(v, f.name))
                for f in dataclasses.fields(v)})
        return (None, "dp") if "cache" in name and v.dim() >= 3 else ("dp",)

    return StreamState(**{f.name: spec(f.name, getattr(state, f.name))
                          for f in dataclasses.fields(StreamState)})


@dataclasses.dataclass
class DPBatch:
    """A batch split over a mesh's dp shards: parts[d], on shard d's lead
    device, holds rows [d * b, (d + 1) * b) (ASRModel.put_batch)."""
    parts: list

    @property
    def shape(self) -> tuple:
        p = self.parts[0]
        return (sum(x.shape[0] for x in self.parts), *p.shape[1:])


def split_rows(mesh: Mesh, arr) -> DPBatch:
    """A host array, axis 0 the stream batch, as a DPBatch (always a
    copy); the rows must divide over dp."""
    arr = np.asarray(arr)
    n_dp = mesh.shape["dp"]
    if arr.shape[0] % n_dp:
        raise ValueError(f"batch {arr.shape[0]} must be divisible by the "
                         f"mesh's dp={n_dp}")
    b = arr.shape[0] // n_dp
    return DPBatch([upload(arr[d * b:(d + 1) * b], row[0])
                    for d, row in enumerate(mesh.devices)])


def shard_inputs(mesh: Mesh, mel_chunk, n_valid, active, prompt_idx=None):
    """The tick's host inputs, each split over dp (split_rows)."""
    out = [split_rows(mesh, x) for x in (mel_chunk, n_valid, active)]
    if prompt_idx is not None:
        out.append(split_rows(mesh, prompt_idx))
    return out


def place_params(params: ModelParams, mesh: Mesh) -> list[TPGroup]:
    """One TPGroup per dp shard: on each of its tp devices the replicated
    parameters and that device's TP_SPLIT slices (params.tp_params); dp
    shards on one device share their tensors."""
    n_tp = mesh.shape["tp"]
    cache: dict = {}
    return [TPGroup(list(row), [tp_params(params, n_tp, t, dev, cache)
                                for t, dev in enumerate(row)])
            for row in mesh.devices]


def _zero_shard(state: StreamState, b: int, devices) -> StreamState:
    """A zero StreamState shaped as `state` with batch b on devices[0],
    its K/V caches as HeadShards over `devices` where there are several."""
    n = len(devices)

    def zeros(t, dev, axis, heads=None):
        shape = list(t.shape)
        shape[axis] = b
        if heads is not None:
            shape[2] = heads
        return torch.zeros(shape, dtype=t.dtype, device=dev)

    def kv(buf):
        heads = (buf.q if is_quant(buf) else buf).shape[2] // n

        def one(dev):
            if is_quant(buf):
                return QuantKV(zeros(buf.q, dev, 1, heads),
                               zeros(buf.s, dev, 1, heads))
            return zeros(buf, dev, 1, heads)
        return one(devices[0]) if n == 1 else HeadShards(
            [one(dev) for dev in devices])

    kw = {}
    for f in dataclasses.fields(StreamState):
        v = getattr(state, f.name)
        if f.name in ("k_cache", "v_cache"):
            kw[f.name] = kv(v)
        elif dataclasses.is_dataclass(v):
            kw[f.name] = dataclasses.replace(v, **{
                g.name: zeros(getattr(v, g.name), devices[0], 0)
                for g in dataclasses.fields(v)})
        else:
            kw[f.name] = zeros(v, devices[0], 1 if f.name == "conv_cache"
                               else 0)
    return StreamState(**kw)


def place(params: ModelParams, state: StreamState, mesh: Mesh):
    """params and a single-device state placed on the mesh: (the dp
    shards' TPGroups, a MeshState holding the state's slots in order)."""
    batch = int(state.cache_valid.shape[0])
    n_dp = mesh.shape["dp"]
    if batch % n_dp:
        raise ValueError(f"stream batch {batch} must be divisible by the "
                         f"mesh's dp={n_dp}")
    b = batch // n_dp
    snaps = extract_slots(state, range(batch))
    shards = []
    for d, row in enumerate(mesh.devices):
        shard = _zero_shard(state, b, row)
        for i in range(b):
            install_slot(shard, i, snaps[d * b + i])
        shards.append(shard)
    return place_params(params, mesh), MeshState(shards)
