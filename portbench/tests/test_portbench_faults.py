"""The check fails a broken timed path: each fault that a serving cell can
have, planted in the program under a whole run of a tiny cell on the CPU
(the harness's look for a card skipped), turns `correct` false. The fault
of the exchange between cards has no place in these one-card cells."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import core
from portbench.tests import tiny


def _tick_fault(kind: str):
    """A wrapper of ASRModel.fused_tick_packed with `kind` planted."""
    from nemotron_tpu_torch import api
    from nemotron_tpu_torch.streaming.state import state_tensors

    orig = api.ASRModel.fused_tick_packed

    def tick(self, cfg, state, packed, all_active, **kw):
        saved = [t.clone() for t in state_tensors(state)]
        state, tokens = orig(self, cfg, state, packed, all_active, **kw)
        if kind == "state unchanged":
            for t, s in zip(state_tensors(state), saved):
                t.copy_(s)
        elif kind == "half the batch left out":
            tokens = tokens.clone()
            tokens[1::2] = -1
        elif kind == "a token altered":
            tokens = tokens.clone()
            flat = tokens.view(-1)
            hit = torch.nonzero(flat >= 0)
            if hit.numel():
                i = hit[0, 0]
                flat[i] = (flat[i] + 1) % (self.hp.vocab_size - 1)
        return state, tokens

    return tick


@pytest.mark.parametrize("kind", ["state unchanged", "half the batch left out",
                                  "a token altered"])
@pytest.mark.parametrize("cell", ["tiny-live", "tiny-backlog"])
def test_a_broken_tick_is_not_correct(tiny_suite, capsys, monkeypatch, cell,
                                      kind):
    from nemotron_tpu_torch import api

    monkeypatch.setattr(api.ASRModel, "fused_tick_packed", _tick_fault(kind))
    line = tiny.run_cell(tiny_suite, cell, capsys)
    assert line["correct"] is False, line["check"]


@pytest.mark.parametrize("kind", ["half the batch left out",
                                  "a token altered"])
def test_a_broken_offline_call_is_not_correct(tiny_suite, capsys,
                                              monkeypatch, kind):
    from nemotron_tpu_torch.models import asr

    orig = asr.transcribe_batch

    def batch(params, mel, **kw):
        tokens, state = orig(params, mel, **kw)
        tokens = tokens.clone()
        if kind == "half the batch left out":
            tokens[1::2] = -1
        else:
            flat = tokens.view(-1)
            hit = torch.nonzero(flat >= 0)
            if hit.numel():
                i = hit[-1, 0]
                flat[i] = (flat[i] + 1) % (params.joint.out_w.shape[0] - 1)
        return tokens, state

    monkeypatch.setattr(asr, "transcribe_batch", batch)
    line = tiny.run_cell(tiny_suite, "tiny-offline", capsys)
    assert line["correct"] is False, line["check"]


def test_an_offline_step_that_keeps_its_state_is_not_correct(
        tiny_suite, capsys, monkeypatch):
    """The offline decode's step (a block of loop iterations) returns its
    carry unchanged: the loop never moves past its first block."""
    from nemotron_tpu_torch.models import asr

    orig = asr.decode_block

    def block(params, hp, carry, n_iter, confidence=False):
        loop = (carry.h, carry.c, carry.prev_token, carry.frame_idx,
                carry.sym_idx)
        saved = [t.clone() for t in loop]
        out = orig(params, hp, carry, n_iter, confidence)
        for t, s in zip(loop, saved):
            t.copy_(s)
        return out

    monkeypatch.setattr(asr, "decode_block", block)
    line = tiny.run_cell(tiny_suite, "tiny-offline", capsys)
    assert line["correct"] is False, line["check"]


@pytest.mark.parametrize("cell", ["tiny-live", "tiny-offline"])
def test_the_control_is_not_correct(tiny_suite, capsys, cell):
    """The control, the reference in fp8 in the program's place, is not
    correct (tiny-live's configuration holds Q8_0 matrices, tiny-offline's
    dense ones)."""
    line = tiny.run_cell(tiny_suite, cell, capsys, control=True)
    assert line["correct"] is False, line["check"]


def test_the_programs_q4_0_path_is_read_on_q8_0_matrices(tiny_suite, capsys):
    """`--control q4_0` runs the program's own Q4_0 path on a Q8_0
    configuration's matrices (tiny-live's), and refuses a dense one
    (tiny-offline's)."""
    line = tiny.run_cell(tiny_suite, "tiny-live", capsys, control="q4_0")
    assert line["correct"] is False, line["check"]
    argv = ["--workload", "tiny-offline", "--seed", "4294967311",
            "--seconds", "2", "--trace", "0", "--control", "q4_0"]
    assert core.main(argv, time.perf_counter(), suite=tiny_suite,
                     device="cpu") == 2
    assert capsys.readouterr().out == ""
