"""The compiled tick's schedule, graphed against eager on the card
(chip_smoke.py phase 10 and tests/test_torch_gpu.py run it).

`run_schedule(model, batch, mode)` drives `ASRModel.fused_tick_packed` as
the engine does, over `passes` passes of one schedule from a primed
state: every phase of a cycle all-active (through the wrap), the backlog
ticks (k = 4 chunks, or k = n_phases below 4 phases; the last one's wrap
inside), a masked fast_gated tick with every other slot paused and the
rest of its cycle all-active (the paused slots realigned on resume), and a
join (a slot reset and primed with a new stream's carry) followed by a
cycle. On a graphed model the first pass warms each key up, the second
captures it and the third replays; with `sync_debug` every tick of the
last pass runs under `torch.cuda.set_sync_debug_mode("error")`. The audio
of each tick is drawn from `seed`, so two models see the same inputs.

`compare(a, b)` holds two states leaf by leaf.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..streaming.engine import PRIME_SAMPLES, prime_carry
from ..streaming.state import reset_slots, state_leaves


def _carries(rng, b: int):
    raw = (rng.standard_normal((b, PRIME_SAMPLES)) * 3000).astype(np.int16)
    tails, lasts = zip(*(prime_carry(r) for r in raw))
    return np.stack(tails), np.asarray(lasts, np.float32)


@contextlib.contextmanager
def _sync_errors(on: bool):
    if not on:
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def run_schedule(model, batch: int, mode: int = 0, passes: int = 3,
                 seed: int = 0, sync_debug: bool = False):
    """The schedule of the module docstring on a fresh state. Returns
    (the tokens of every tick as host arrays, the final state)."""
    cfg = model.cache_config(mode)
    n = cfg.n_phases
    k = 4 if n % 4 == 0 else n
    rng = np.random.default_rng(seed)
    state = model.init_stream_state(batch, cfg)
    state = model.prime_frontend(state, np.ones(batch, bool),
                                 *_carries(rng, batch))
    half = np.arange(batch) % 2 == 0  # odd slots paused
    toks = []

    def tick(k=1, phase=0, active=None, last=False):
        nonlocal state
        audio = (rng.standard_normal((batch, k * cfg.shift_samples)) * 3000
                 ).astype(np.int16)
        packed = model.put_batch(model.pack_tick_inputs(
            audio, np.full(batch, cfg.valid_out_len), np.zeros(batch),
            active))
        with _sync_errors(last):
            state, tokens = model.fused_tick_packed(
                cfg, state, packed, active is None, phase=phase, k=k,
                fast_gated=True)
        # the tokens leave the static output before the next replay
        host = torch.empty(tokens.shape, dtype=tokens.dtype,
                           pin_memory=tokens.is_cuda)
        toks.append(host.copy_(tokens, non_blocking=True))

    def cycle(last, start=0):
        nonlocal state
        for phase in range(start, n):
            tick(phase=phase, last=last)
        state = model.compact_state(cfg, state)

    for p in range(passes):
        last = sync_debug and p == passes - 1
        cycle(last)
        for phase in range(0, n, k):  # the backlog; the last wraps inside
            tick(k=k, phase=phase, last=last)
        tick(phase=0, active=half, last=last)  # odd slots paused
        # they resume one phase behind: realign +1
        state = model.realign_state(cfg, state, 1, ~half)
        cycle(last, start=1)
        join = np.zeros(batch, bool)
        join[1] = True  # a new stream in slot 1
        state = reset_slots(state, join, model.hp)
        state = model.prime_frontend(state, join, *_carries(rng, batch))
        cycle(last)
    model.synchronize()
    return [t.numpy() for t in toks], state


def compare(a, b) -> dict:
    """Leaf by leaf (state_leaves order): {"equal": all bit-equal,
    "max_abs": the largest |a - b| over the leaves as f32, "leaves": how
    many}."""
    la, lb = state_leaves(a), state_leaves(b)
    eq = all(torch.equal(x, y) for x, y in zip(la, lb))
    diff = max(float((x.float() - y.float()).abs().max()) if x.numel()
               else 0.0 for x, y in zip(la, lb))
    return {"equal": eq, "max_abs": diff, "leaves": len(la)}
