"""The port's offline tokens against tests/torch_oracle.py (torch.stft mel,
F.conv2d subsampling, HF's rel-pos attention, torch.nn.LSTM and a torch
greedy loop), as tests/test_e2e_oracle.py holds the JAX package's: the
port's mel + transcribe_mel and the oracle's pipeline from its own mel give
identical tokens. Most of its time is the import of transformers."""

import numpy as np
import pytest
import torch

from helpers import tiny_model

import nemotron_tpu_torch.api as tapi
from nemotron_tpu_torch.audio.frontend import mel_full

torch.set_num_threads(1)


def test_offline_tokens_match_torch_oracle():
    """audio -> tokens: the port's pipeline against the oracle's, each from
    its own mel (the two frontends agree to ~3e-4): identical tokens."""
    pytest.importorskip("transformers")
    import torch_oracle as O

    hp, jparams = tiny_model(seed=0)
    model = tapi.ASRModel.random(hp, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    t = np.arange(16000) / 16000.0
    sig = (0.4 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 3 * t) > 0)
           + 0.3 * np.sin(2 * np.pi * 530 * t)
           + 0.08 * rng.standard_normal(16000))
    pcm = (np.clip(sig, -1, 1) * 30000).astype(np.int16)
    mel = mel_full(pcm, model.params.preproc.filterbank,
                   model.params.preproc.window)
    got, _ = model.transcribe_mel(mel)
    mel_oracle = O.torch_mel(
        pcm, np.asarray(jparams.preproc.filterbank),
        np.asarray(jparams.preproc.window)).numpy()[:mel.shape[0]]
    want = O.oracle_transcribe_offline(mel_oracle, jparams, hp)
    assert len(want) > 3
    assert got == want
