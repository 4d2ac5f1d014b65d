"""The reference agrees with the port on the CPU at a tiny size, in float32:
its banded full pass equals the port's cache-aware chunked encoder, its
segmented offline encoder the port's offline one, and every decision the
port serves in a whole run of each tiny cell is the reference's best
choice."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import gen
from portbench.archs.fastconformer_rnnt import model as model_mod
from portbench.archs.fastconformer_rnnt import reference as ref
from portbench.tests import tiny


@pytest.fixture(scope="module")
def tiny_model():
    conf = {"model": tiny.TINY_MODEL, "activations": "float32",
            "q8_0_fields": tiny.MATRICES}
    w = model_mod.make_weights(conf, 3, "cpu")
    w["joint.out_b"][-1] = 2.0
    return conf, w, model_mod.program_model(conf, w, "cpu")


@pytest.mark.parametrize("right_context", [0, 1, 6])
def test_stream_encoder_matches_the_chunked_port(tiny_model, right_context):
    """Through several wraps and, past R=0, a last chunk that the audio
    ends inside: sent whole, zero-padded, as a finalizing stream's is."""
    from nemotron_tpu_torch.models.asr import fused_encode_tick
    from nemotron_tpu_torch.models.encoder import compact_cache
    from nemotron_tpu_torch.streaming import state as st
    from nemotron_tpu_torch.streaming.engine import PRIME_SAMPLES, prime_carry

    conf, w, model = tiny_model
    audio = gen.audio_pool(6.5, 5, "cpu")
    n_frames = ref.stream_frames(conf["model"], right_context, len(audio))
    cfg = model.cache_config(right_context)
    padded = np.concatenate([audio, np.zeros(cfg.shift_samples, audio.dtype)])
    state = model.init_stream_state(1, cfg)
    tail, last = prime_carry(audio[:PRIME_SAMPLES])
    st.prime_frontend(state, torch.tensor([True]), torch.tensor(tail[None]),
                      torch.tensor([last]))
    pos, phase, encs = PRIME_SAMPLES, 0, []
    with torch.no_grad():
        while sum(e.shape[0] for e in encs) < n_frames:
            block = torch.from_numpy(padded[None, pos:pos + cfg.shift_samples])
            state, enc = fused_encode_tick(model.params, state, block, None,
                                           hp=model.hp, cfg=cfg, phase=phase)
            encs.append(enc[0])
            pos += cfg.shift_samples
            phase += 1
            if phase == cfg.n_phases:
                compact_cache(cfg, model.hp, state.k_cache, state.v_cache)
                phase = 0
        port = torch.cat(encs)[:n_frames]
        mine = ref.stream_encoder(w, conf["model"], torch.from_numpy(audio),
                                  right_context)
    assert n_frames > 3 * cfg.n_phases  # through several wraps
    assert (pos > len(audio)) == (right_context > 0)  # a partial last chunk
    assert mine.shape[0] == n_frames
    np.testing.assert_allclose(mine.numpy(), port.numpy(), atol=2e-4, rtol=0)


def test_offline_encoder_matches_the_port(tiny_model):
    from nemotron_tpu_torch.models.encoder import encode_batch

    conf, w, model = tiny_model
    audio = gen.audio_pool(7.0, 6, "cpu")
    mel = ref.log_mel(torch.from_numpy(audio), w["pre.filterbank"],
                      w["pre.window"])
    port_mel = model._preprocessor().process(audio)
    np.testing.assert_allclose(mel.numpy(), port_mel, atol=2e-4, rtol=0)
    seg = ref.max_seg_mel_frames(conf["model"])
    assert mel.shape[0] > seg  # two segments
    with torch.no_grad():
        port = torch.cat([encode_batch(model.params, model.hp,
                                       torch.from_numpy(port_mel[None,
                                                                 s:s + seg]))[0]
                          for s in range(0, mel.shape[0], seg)])
        mine = ref.offline_encoder(w, conf["model"], torch.from_numpy(audio))
    np.testing.assert_allclose(mine.numpy(), port.numpy(), atol=2e-4, rtol=0)


@pytest.mark.parametrize("cell", ["tiny-live", "tiny-backlog",
                                  "tiny-offline"])
def test_every_served_decision_is_the_references_best(tiny_suite, capsys,
                                                      cell):
    line = tiny.run_cell(tiny_suite, cell, capsys, seed=2 ** 33 + 17)
    assert line["correct"] is True
    assert line["check"]["max_gap"]["value"] < 1e-4
    err = capsys.readouterr().err
    assert line["attempted"] > 0 and line["failed"] == 0, err
