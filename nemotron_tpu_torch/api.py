"""Model handle for the streaming engine, the single-stream session and
offline transcription (port of the serving surface, `stream_step`,
`fused_tick_profiled`, `weights_fingerprint` and `transcribe_mel` /
`transcribe_audio` / `transcribe_audios` of nemotron_tpu/api.py:ASRModel).

The model lives on `device`, the card unless the caller asks for the CPU
(`device="cpu"`); where no card is found, a model on "cuda" raises, and
nothing falls back to the CPU. Its encoder matrices may be
weight-only quantized (Q8_0 / Q4_0, `from_gguf(keep_quantized=True)` or
`params.quantize_encoder_layers`), and `kv_int8` gives its streams int8 K/V
caches. Two more explicit arguments stand in for the JAX package's
environment variables: `attn_block` (NEMOTRON_TPU_PALLAS_ATTN_BLOCK) runs
each layer's attention sub-block as one call of kernel B3 at chunk_len 1,
and `confidence` (NEMOTRON_TPU_CONFIDENCE) packs per-token confidences into
the tokens. The entry points (the server, the streaming CLI) map the
environment variable of the attention block onto the argument. Float32
numerics are pinned: the
port turns TF32 off for matmuls and for cuDNN convolutions (cuDNN runs f32
convolutions in TF32 by default, which alone would move the subsampling
output by ~1e-3 against the JAX package).

On the card every serving entry point (`fused_tick_packed` in all its
forms, `stream_step`, the two halves of `fused_tick_profiled`) runs as one
CUDA graph per JAX key (nemotron_tpu/api.py `_memo`'s keys), captured on
the key's second call and replayed after that (graphs.py; `model.graphs`
holds them). So do the slot operations between ticks (`prime_frontend`,
`reset_state`, `compact_state`, `realign_state`: JAX's
`("compact", cfg, phase, masked)` and `("realign", cfg, delta)`, and
`("prime", cfg)` and `("reset", cfg)`, which carry the engine group's
cache config so that each group of a model keeps its own graph), whose
K/V moves run on kernel kv_rows with the slot mask read on the device,
and whose host inputs go up without a sync (`put_batch`). So does the offline path: each segment's encoder is one
graph per JAX key ("batch", T, B) (`_batch_fn`'s), and its greedy decode
replays one graph per batch size, a block of models/asr.DECODE_EXIT_EVERY
iterations, between the host's exit tests (`_transcribe_mels`). The
offline graphs have a pool of their own, which `drop_offline_graphs`
frees while the ticks' graphs stay. `graphs=False` runs the same bodies
eagerly on the card, as the CPU does. On a mesh each of these is one
graph per JAX key and dp shard, a tp group's too: its ranks run on
streams of their own (params.TPGroup.each), forked from the capture
stream and joined back, so the graph holds a branch per rank.

`shard(mesh)` serves over a device mesh (parallel/mesh.py): the parameters
replicated over 'dp' and split over 'tp', each stream state a MeshState
split over dp, each host input of put_batch a DPBatch split the same way;
every tick then runs once per dp shard (its tp devices inside the
encoder), and the tokens come back in slot order on the lead device.
`params` keeps the logical weights (the fingerprint is the single
device's), and the offline path runs on dp shard 0 (its tp devices in
the encoder).
"""

from __future__ import annotations

import numpy as np
import torch

from .audio.frontend import StreamPreprocessor, process_many
from .graphs import GraphCache
from .models import asr
from .models.decoder import init_carry, init_decode_state
from .models.encoder import (check_attn_block_weights, compact_cache,
                             realign_cache)
from .params import (ModelParams, device_of, load_model, on_device,
                     param_leaves, random_params, upload)
from .config import CacheConfig, Hparams, LatencyMode
from .text.tokenizer import Tokenizer
from .streaming import state as state_mod
from .utils.trace import Totals

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Multilingual default prompt index 101 = "auto".
DEFAULT_PROMPT_INDEX = 101

MEL_BUCKET = 1024  # offline segments are padded to a multiple of this
OFFLINE_KEYS = ("batch", "batch_decode")  # the offline graphs' key kinds


def _offline_counts(graphs: GraphCache) -> dict:
    """Each offline key's (calls, captures, replays) so far."""
    return {key: (e.calls, e.captures, e.replays)
            for (key, _shard), e in graphs.entries.items()
            if key[0] in OFFLINE_KEYS}


class ASRModel:
    def __init__(self, hp: Hparams, params: ModelParams,
                 vocab: list[str] | None = None,
                 prompt_dict: dict[str, int] | None = None,
                 device="cuda", kv_int8: bool = False,
                 attn_block: bool = False, confidence: bool = False,
                 graphs: bool = True):
        self.hp = hp
        self.params = params
        self.device = device_of(device)
        self.kv_int8 = kv_int8  # int8 QuantKV attention caches
        self.attn_block = attn_block  # kernel B3 for the attention sub-block
        self.confidence = confidence  # packed per-token confidences
        if attn_block:
            check_attn_block_weights(params.layers)
        # the device mesh (parallel/mesh.py), None on one device; groups:
        # each dp shard's TPGroup
        self.mesh = None
        self.groups = None
        self.tokenizer = Tokenizer(vocab or [])
        self.prompt_dict = prompt_dict or {}
        self.default_prompt_index = (
            DEFAULT_PROMPT_INDEX if hp.num_prompts > 0 else -1)
        if hp.num_prompts > 0 and self.default_prompt_index >= hp.num_prompts:
            self.default_prompt_index = 0
        # the longest offline segment whose subsampled length fits the
        # pos table
        t = 8 * hp.max_pos_len
        while hp.subsampled_len(t) > hp.max_pos_len:
            t -= 8
        self.max_seg_mel_frames = t
        # per segment of the last offline call: batch, padded mel frames,
        # the decode's iterations, the seconds of its encoder's launch and
        # of its decode (the `offline.encoder` and `offline.decode` spans),
        # and each graph key's "calls", "captures" and "replays" in the
        # segment ("graphs"; a call that did not replay ran eagerly)
        self.offline_stats: list[dict] = []
        # the last offline call's spans (utils/trace.py): one
        # `offline.call` root
        self.offline_spans = Totals()
        # the graphed offline decode's fixed storage, one per (batch,
        # device)
        self._carries: dict = {}
        self._weights_fp: str | None = None  # see weights_fingerprint
        # the compiled ticks, one CUDA graph per JAX key (graphs.py)
        self.graphs = GraphCache(enabled=graphs)

    @classmethod
    def from_gguf(cls, path: str, dtype=torch.float32, device="cuda",
                  keep_quantized: bool = False, kv_int8: bool = False,
                  attn_block: bool = False, confidence: bool = False,
                  graphs: bool = True):
        hp, params, meta = load_model(path, dtype=dtype, device=device,
                                      keep_quantized=keep_quantized)
        return cls(hp, params, meta["vocab"], meta["prompt_dict"], device,
                   kv_int8=kv_int8, attn_block=attn_block,
                   confidence=confidence, graphs=graphs)

    @classmethod
    def random(cls, hp: Hparams | None = None, seed: int = 0,
               dtype=torch.float32, device="cuda", kv_int8: bool = False,
               attn_block: bool = False, confidence: bool = False,
               graphs: bool = True):
        hp = hp or Hparams()
        vocab = [("▁w%d" % i) if i % 2 == 0 else ("p%d" % i)
                 for i in range(hp.vocab_size - 1)]
        return cls(hp, random_params(hp, seed=seed, dtype=dtype,
                                     device=device), vocab, device=device,
                   kv_int8=kv_int8, attn_block=attn_block,
                   confidence=confidence, graphs=graphs)

    def cache_config(self, mode: LatencyMode | int = LatencyMode.PURE_CAUSAL):
        return CacheConfig.for_mode(mode, self.hp)

    def shard(self, mesh) -> "ASRModel":
        """Serve over `mesh`: the parameters placed on its devices
        (parallel/mesh.place_params), and from now on every stream state
        a MeshState and every put_batch a DPBatch split over its dp
        shards. One engine then ticks every shard. Every graph is dropped
        (the JAX package clears its executables). Returns self."""
        from .parallel.mesh import place_params

        self.graphs.clear()
        self._carries.clear()
        self.groups = place_params(self.params, mesh)
        self.mesh = mesh
        self.device = mesh.devices[0][0]
        return self

    @property
    def backend_name(self) -> str:
        if self.mesh is not None:
            return f"mesh {self.mesh}"
        return f"{self.device.type}:{self.device.index or 0}"

    def _shards(self):
        """(params, tp group or None, lead device) per dp shard."""
        if self.mesh is None:
            return [(self.params, None, self.device)]
        return [(g.lead, g if len(g.devices) > 1 else None, g.devices[0])
                for g in self.groups]

    def _shard_calls(self, state, fn, *batched, key=None) -> list:
        """[fn(params, tp, state, *rows)] of each dp shard (on a single
        device: the model's params and state as they are). With a JAX
        `key`, fn returns (state, *outputs) and each shard's call goes
        through the graph cache (graphs.py): one graph per key and dp
        shard on that shard's lead device, a tp group's with a branch per
        rank stream (its reduction's copies across devices inside)."""
        if self.mesh is None:
            return [self._call(key, 0, self.params, None, self.device, state,
                               fn, batched)]
        outs = []
        for d, (params, tp, dev) in enumerate(self._shards()):
            with on_device(dev):
                outs.append(self._call(key, d, params, tp, dev,
                                       state.shards[d], fn,
                                       [b.parts[d] for b in batched]))
        return outs

    def _call(self, key, shard, params, tp, dev, state, fn, rows):
        if key is None:
            return fn(params, tp, state, *rows)

        def body(s, *r):
            return fn(params, tp, s, *r)[1:]

        return (state, *self.graphs.run(
            key, shard, dev, body, state, tuple(rows),
            devices=() if tp is None else tp.devices))

    def _per_shard(self, state, fn, *batched, with_tokens=True, key=None):
        """fn(params, tp, state, *rows) on each dp shard (_shard_calls);
        the shards' states make a MeshState (the caller's own where each
        shard's state is the caller's shard, as a keyed body's is: its
        storage written in place) and their tokens (with_tokens) one
        tensor in slot order on the lead device. Without tokens fn
        returns (state,) and the state comes back alone."""
        outs = self._shard_calls(state, fn, *batched, key=key)
        if self.mesh is None:
            return outs[0] if with_tokens else outs[0][0]
        states = [o[0] for o in outs]
        if all(s is t for s, t in zip(states, state.shards)):
            new = state
        else:
            new = state_mod.MeshState(states)
        if not with_tokens:
            return new
        return new, torch.cat([o[1].to(self.device) for o in outs])

    @property
    def weights_fingerprint(self) -> str:
        """Content fingerprint of the model, stamped into live-stream
        snapshots and checked when one is imported: sha256 of repr(hp), the
        vocabulary, the sorted prompt table, then "shape:dtype;" of every
        weight leaf and the first 64 elements of each, upcast to f32 (exact
        for f32, bf16 and int8). The leaves go in the JAX package's pytree
        order with numpy dtype names, so the same weights give the same
        digest in both packages (nemotron_tpu/api.py:weights_fingerprint)
        and snapshots cross between them. Computed once per model, with one
        host copy."""
        if self._weights_fp is None:
            import hashlib

            h = hashlib.sha256()
            h.update(repr(self.hp).encode("utf-8"))
            h.update("\x00".join(self.tokenizer.vocab).encode("utf-8"))
            h.update(repr(sorted(self.prompt_dict.items())).encode("utf-8"))
            leaves = param_leaves(self.params)
            for x in leaves:
                dt = str(x.dtype).removeprefix("torch.")
                h.update(f"{tuple(x.shape)}:{dt};".encode("utf-8"))
            sample = torch.cat([x.flatten()[:64].float() for x in leaves])
            h.update(sample.cpu().numpy().tobytes())
            self._weights_fp = h.hexdigest()
        return self._weights_fp

    def resolve_language(self, lang: str) -> int | None:
        if self.hp.num_prompts <= 0:
            return None
        return self.prompt_dict.get(lang)

    def put_batch(self, arr):
        """Host array -> a tensor on the model's device (always a copy; to a
        card a non-blocking copy through pinned memory, params.upload, so
        it does not wait for the queued ticks); on a mesh a DPBatch, axis 0
        (the stream batch) split over dp."""
        if self.mesh is not None:
            from .parallel.mesh import split_rows

            return split_rows(self.mesh, arr)
        return upload(arr, self.device)

    def init_stream_state(self, batch: int, cfg: CacheConfig):
        # the activation type, read from a leaf that is never quantized
        kw = dict(dtype=self.params.pos_emb.dtype, kv_int8=self.kv_int8)
        if self.mesh is None:
            return state_mod.init_stream_state(batch, self.hp, cfg,
                                               device=self.device, **kw)
        n_dp = self.mesh.shape["dp"]
        if batch % n_dp:
            raise ValueError(
                f"stream batch {batch} must be divisible by the mesh's "
                f"dp={n_dp}")
        return state_mod.MeshState([
            state_mod.init_stream_state(batch // n_dp, self.hp, cfg,
                                        device=g.devices[0],
                                        kv_devices=g.devices, **kw)
            for g in self.groups])

    @staticmethod
    def pack_tick_inputs(audio_block, n_valid, prompt_idx, active):
        """Host-side packing for fused_tick_packed: [B, k*shift+3] int16
        (audio | n_valid | prompt | active): one upload per tick."""
        b = audio_block.shape[0]
        cols = np.empty((b, 3), dtype=np.int16)
        cols[:, 0] = n_valid
        cols[:, 1] = prompt_idx if prompt_idx is not None else 0
        cols[:, 2] = active if active is not None else 1
        return np.concatenate([audio_block, cols], axis=1)

    def fused_tick_packed(self, cfg, state, packed_dev, all_active: bool,
                          phase: int = 0, k: int = 1,
                          fast_gated: bool = False):
        """One fused tick on a packed input (see pack_tick_inputs). The
        state's caches are updated in place. k > 1 (all-active only)
        advances every stream by k chunks, wrap compaction included; the
        caller's phase then advances by k mod n_phases. A partially active
        batch runs the masked fast path with fast_gated (the engine
        realigns paused slots on resume), else the legacy gated tick,
        phase-stationary (the caller keeps its phase; the JAX package runs
        it at phase 0 only, after a compaction)."""
        if k > 1 and not all_active:
            raise ValueError("multi-chunk ticks are all-active only")
        hp = self.hp
        shift = cfg.shift_samples
        flags = dict(attn_block=self.attn_block, confidence=self.confidence)
        key = ("tick_packed", cfg, packed_dev.shape[0], all_active, phase, k,
               fast_gated and not all_active)

        def tick(params, tp, state, packed):
            audio = packed[:, :k * shift]
            n_valid = packed[:, k * shift].to(torch.int32)
            prompt = (packed[:, k * shift + 1].to(torch.int32)
                      if hp.num_prompts > 0 else None)
            if k > 1:
                return asr.fused_serve_tick_scan(
                    params, state, audio, n_valid, prompt, hp=hp, cfg=cfg,
                    k=k, phase=phase, tp=tp, **flags)
            act = None if all_active else packed[:, k * shift + 2] != 0
            return asr.fused_serve_tick(
                params, state, audio, n_valid, act, prompt, hp=hp, cfg=cfg,
                phase=phase, fast_gated=fast_gated, tp=tp, **flags)

        return self._per_shard(state, tick, packed_dev, key=key)

    def fused_tick_profiled(self, cfg, state, audio_block, n_valid, active,
                            prompt_idx=None, phase: int = 0, spans=None):
        """The fused tick in two halves, each timed on the host clock up to
        a device synchronisation: the encoder half (the frontend, kernel B2,
        and the encoder; fused_encode_tick) and the decoder half
        (decode_tick); the reference's encoder/decoder attribution
        (nemo-stream.h:237-244), nemotron_tpu/api.py:fused_tick_profiled.
        active None is the all-active fast path at `phase`, else the legacy
        gated tick. Tensors on the model's device. The halves are spans
        `engine.encoder` and `engine.decoder` of `spans` (a caller's
        utils/trace.Totals; a table of their own by default). Returns
        (state, tokens, encoder_seconds, decoder_seconds)."""
        spans = spans or Totals()
        b = audio_block.shape[0]
        if prompt_idx is None:
            prompt_idx = self.put_batch(np.full(
                (b,), max(self.default_prompt_index, 0), np.int32))
        use_prompt = self.hp.num_prompts > 0
        act = [] if active is None else [active]

        def encode(params, tp, state, audio, prompt, act=None):
            return asr.fused_encode_tick(
                params, state, audio, act, prompt if use_prompt else None,
                hp=self.hp, cfg=cfg, phase=phase, attn_block=self.attn_block,
                tp=tp)

        def decode(params, tp, state, enc, nv, act=None):
            return asr.decode_tick(params, state, enc, nv, act, hp=self.hp,
                                   confidence=self.confidence)

        with spans.span("engine.encoder") as enc_span:
            outs = self._shard_calls(
                state, encode, audio_block, prompt_idx, *act,
                key=("fused_encode", cfg, b, active is None, phase))
            if self.mesh is None:
                state, enc = outs[0]
            else:
                from .parallel.mesh import DPBatch

                state = state_mod.MeshState([o[0] for o in outs])
                enc = DPBatch([o[1] for o in outs])
            self.synchronize()
        with spans.span("engine.decoder") as dec_span:
            state, tokens = self._per_shard(
                state, decode, enc, n_valid, *act,
                key=("decode", active is None, cfg, b))
            self.synchronize()
        return state, tokens, enc_span.seconds, dec_span.seconds

    def stream_step(self, cfg, state, mel_chunk, n_valid, active,
                    prompt_idx=None, phase: int = 0):
        """One chunk of mel frames [B, chunk_mel_frames, n_mels] for every
        stream (tensors on the model's device). active None: the all-active
        fast path, after which the caller advances the phase and calls
        compact_state at the wrap; active [B] bool: the legacy gated step
        (phase-stationary, inactive slots untouched). The state's caches
        are updated in place."""
        if prompt_idx is None:
            prompt_idx = self.put_batch(np.full(
                (mel_chunk.shape[0],), max(self.default_prompt_index, 0),
                np.int32))
        use_prompt = self.hp.num_prompts > 0

        def step(params, tp, state, mel, nv, prompt, act=None):
            return asr.stream_step(
                params, state, mel, nv, act, prompt if use_prompt else None,
                hp=self.hp, cfg=cfg, phase=phase, attn_block=self.attn_block,
                confidence=self.confidence, tp=tp)

        return self._per_shard(
            state, step, mel_chunk, n_valid, prompt_idx,
            *([] if active is None else [active]),
            key=("stream_step", cfg, mel_chunk.shape[0], active is None,
                 phase))

    # The slot operations between ticks. Each is one CUDA graph per key
    # and dp shard on the card (JAX's ("compact", cfg, phase, masked) and
    # ("realign", cfg, delta); JAX's ("prime",) and the reset, eager jnp
    # ops in the JAX package, as ("prime", cfg) and ("reset", cfg)), the
    # mask a graph input; the K/V moves go through kernel kv_rows, which
    # reads the mask on the device. A key's graph is bound to the state's
    # storage (graphs.py), so each key names the engine group's cfg: one
    # key for two groups would be captured anew whenever they take turns.

    def prime_frontend(self, state, mask, tails, lasts, cfg=None):
        """Install frontend carries for newly joined slots. `cfg`: the
        state's cache config (it keys the graph)."""
        def prime(_p, _tp, s, *rows):  # the lead's leaves alone
            return (state_mod.prime_frontend(s, *rows),)

        return self._per_shard(
            state, prime, self.put_batch(mask), self.put_batch(tails),
            self.put_batch(lasts), with_tokens=False, key=("prime", cfg))

    def reset_state(self, state, mask, cfg=None):
        """Zero the slots where mask[b] is True (a stream joins), in
        place (streaming/state.reset_slots). `cfg`: the state's cache
        config (it keys the graph)."""
        def reset(_p, tp, s, m):
            return (state_mod.reset_slots(s, m, self.hp, tp),)

        return self._per_shard(state, reset, self.put_batch(mask),
                               with_tokens=False, key=("reset", cfg))

    def compact_state(self, cfg, state, phase: int | None = None, mask=None):
        """Move the live K/V window back to phase 0 (in place). `phase` is
        the caller's CURRENT phase (default: the wrap); `mask` restricts the
        compaction to those slots."""
        if phase is None:
            phase = cfg.n_phases
        if phase == 0:
            return state

        def compact(_p, tp, state, m=None):
            compact_cache(cfg, self.hp, state.k_cache, state.v_cache,
                          phase=phase, mask=m, tp=tp)
            return (state,)

        return self._per_shard(
            state, compact, *([] if mask is None else [self.put_batch(mask)]),
            with_tokens=False, key=("compact", cfg, phase, mask is not None))

    def realign_state(self, cfg, state, delta: int, mask):
        """Move masked slots' K/V windows forward by `delta` phases."""
        def realign(_p, tp, state, m):
            realign_cache(cfg, self.hp, state.k_cache, state.v_cache, delta,
                          m, tp=tp)
            return (state,)

        return self._per_shard(state, realign, self.put_batch(mask),
                               with_tokens=False,
                               key=("realign", cfg, delta))

    def drop_offline_graphs(self) -> None:
        """Free the offline path's graphs, their pool and the decode's
        carries (a graph holds the encoder's working set while it lives);
        the ticks' graphs stay. The next offline call warms up again."""
        self.graphs.drop(lambda key: key[0] in OFFLINE_KEYS)
        self._carries.clear()

    def _carry(self, b: int, dev):
        """The graphed offline decode's carry for batch b on dev, at the
        longest segment's frames, so every segment of a batch size replays
        one decode graph. Kept while the graphs live (an eager decode
        makes its carry per segment, at the segment's frames)."""
        if (b, dev) not in self._carries:
            self._carries[b, dev] = init_carry(
                b, self.hp.subsampled_len(self.max_seg_mel_frames), self.hp,
                self.params.pos_emb.dtype, device=dev)
        return self._carries[b, dev]

    def _preprocessor(self):
        return StreamPreprocessor(self.params.preproc.filterbank,
                                  self.params.preproc.window)

    def _transcribe_mels(self, mels, prompt_index):
        """Offline transcription of mels ([T_i, n_mels] host arrays) as one
        zero-padded batch per segment of max_seg_mel_frames (each padded
        to a multiple of MEL_BUCKET), the decoder state carried from one
        segment to the next. Returns ([(token_ids, frame_indices)] per
        mel, the last segment's decoder state). On a mesh, on dp shard 0,
        graphed as on one device: its tp devices in the encoder's graph
        (a branch per rank stream), the decode and its carry on its lead.
        A segment is the encoder's graph, key ("batch", T, B), then the
        decode's blocks, key ("batch_decode", B, frames, confidence), then
        the tokens' host copy."""
        hp = self.hp
        params, tp, dev = self._shards()[0]
        b = len(mels)
        if prompt_index is None:
            prompt_index = self.default_prompt_index
        pidx = (torch.full((b,), max(prompt_index, 0), dtype=torch.int32,
                           device=dev) if hp.num_prompts > 0 else None)
        dec_state = init_decode_state(b, hp, dtype=self.params.pos_emb.dtype,
                                      device=dev)
        out = [([], []) for _ in range(b)]
        offsets = [0] * b
        seg = self.max_seg_mel_frames
        graphed = self.graphs.enabled and dev.type == "cuda"
        carry = self._carry(b, dev) if graphed else None

        def run(key, body, state, inputs):
            return self.graphs.run(key, 0, dev, body, state, inputs,
                                   pool="offline",
                                   devices=() if tp is None else tp.devices)

        self.offline_stats = []
        sp = self.offline_spans
        for start in range(0, max(max(m.shape[0] for m in mels), 1), seg):
            parts = [m[start:start + seg] for m in mels]
            t_max = max(p.shape[0] for p in parts)
            if t_max == 0:
                break
            t_pad = min(-(-t_max // MEL_BUCKET) * MEL_BUCKET, seg)
            with sp.span("offline.segment"):
                with sp.span("offline.pad"):
                    padded = np.zeros((b, t_pad, hp.n_mels), dtype=np.float32)
                    n_mel = np.array([p.shape[0] for p in parts],
                                     dtype=np.int32)
                    n_sub = np.array([hp.subsampled_len(n) if n else 0
                                      for n in n_mel], dtype=np.int32)
                    for i, p in enumerate(parts):
                        padded[i, :p.shape[0]] = p
                stats = {"batch": b, "mel_frames": t_pad}
                before = _offline_counts(self.graphs)
                with sp.span("offline.upload"):
                    mel_dev, n_sub_dev, n_mel_dev = (
                        torch.tensor(a, device=dev)
                        for a in (padded, n_sub, n_mel))
                tokens, dec_state = asr.transcribe_batch(
                    params, mel_dev, hp=hp, prompt_idx=pidx,
                    n_frames=n_sub_dev, dec_state=dec_state,
                    n_mel_frames=n_mel_dev, confidence=self.confidence,
                    stats=stats, tp=tp, carry=carry, run=run, spans=sp)
                stats["graphs"] = {
                    key: {f: x - y for f, x, y in zip(
                        ("calls", "captures", "replays"), n,
                        before.get(key, (0, 0, 0)))}
                    for key, n in _offline_counts(self.graphs).items()
                    if n != before.get(key)}
                self.offline_stats.append(stats)
                with sp.span("offline.tokens"):
                    seqs = asr.tokens_to_list(
                        tokens, n_sub,
                        vocab_size=hp.vocab_size if self.confidence
                        else None)
                    for i, seq in enumerate(seqs):
                        for tok, t in seq:
                            out[i][0].append(tok)
                            out[i][1].append(offsets[i] + t)
                        offsets[i] += int(n_sub[i])
        return out, dec_state

    def _offline_call(self):
        """The root span of one offline call, on a fresh span table
        (offline_spans): its mel (`offline.mel`), one `offline.segment`
        per segment window (_transcribe_mels) and its detokenizer
        (`offline.detok`) go under it."""
        self.offline_spans = Totals()
        return self.offline_spans.span("offline.call")

    def transcribe_mel(self, mel: np.ndarray,
                       prompt_index: int | None = None):
        """Offline transcription of one mel sequence [T, n_mels]; long
        audio runs in segments at the pos table's cap with the decoder
        state carried across them. Returns (token_ids, frame_indices)."""
        with self._offline_call():
            return self._transcribe_mels([np.asarray(mel)],
                                         prompt_index)[0][0]

    def transcribe_audio(self, audio_i16, prompt_index: int | None = None,
                         timestamp_words: bool = False) -> str:
        """PCM (s16le 16 kHz mono) -> text: the file's mel in one call of
        kernel B2, then the segments as transcribe_mel runs them."""
        with self._offline_call():
            with self.offline_spans.span("offline.mel"):
                mel = self._preprocessor().process(audio_i16)
            token_ids, frames = self._transcribe_mels([mel],
                                                      prompt_index)[0][0]
            with self.offline_spans.span("offline.detok"):
                return self.tokenizer.decode(token_ids, timestamp_words,
                                             frames)

    def transcribe_audios(self, audios, prompt_index: int | None = None,
                          timestamp_words: bool = False) -> list[str]:
        """Several files as one ragged batch: every file's mel in one call
        of kernel B2 (frontend.process_many; each file's values as its own
        preprocessor gives them), then one padded batch per segment window
        (ragged lengths through the key mask and the subsampling's masks),
        each file's decoder state carried across segments as in
        transcribe_mel. Equal to transcribe_audio file by file."""
        if not len(audios):
            return []
        with self._offline_call():
            with self.offline_spans.span("offline.mel"):
                mels = process_many([self._preprocessor() for _ in audios],
                                    audios)
            results = self._transcribe_mels(mels, prompt_index)[0]
            with self.offline_spans.span("offline.detok"):
                return [self.tokenizer.decode(ids, timestamp_words, frames)
                        for ids, frames in results]

    def synchronize(self) -> None:
        """Wait for the device's queued work (block_until_ready); on a
        mesh, every card's."""
        devs = ({d for row in self.mesh.devices for d in row}
                if self.mesh is not None else {self.device})
        for d in devs:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
