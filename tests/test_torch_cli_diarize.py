"""The port's streaming CLI with diarization (`--diarize GGUF` with --rttm,
--speaker-text, --json, --num-speakers, --sub-shift; --confidence feeding
the word JSON) against the JAX package's CLI on the same files: a tiny
random ASR GGUF, the random diarize checkpoint of
tests/scripts_support.export_random_diarize_checkpoint (seed 7) and 3 s of
seed-made audio, two tones a second apart. stdout equal, byte for byte.

The JAX CLI is given one ASR model (its from_gguf patched to return it),
and both packages run right context 0 with N_PHASES slack-buffer phases
(as tests/test_torch_cli.py)."""

import json

import numpy as np
import pytest
import torch

from helpers import tiny_hparams
from scripts_support import (export_random_checkpoint,
                             export_random_diarize_checkpoint)

from nemotron_tpu.api import ASRModel as JaxModel
from nemotron_tpu.cli import transcribe_stream as jcli
from nemotron_tpu.config import CacheConfig as JaxCacheConfig
from nemotron_tpu_torch.cli import transcribe_stream as tcli
from nemotron_tpu_torch.config import CacheConfig

torch.set_num_threads(1)

N_PHASES = 2


@pytest.fixture(scope="module", autouse=True)
def few_phases():
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JaxCacheConfig, CacheConfig):
            mp.setitem(cls._MODE_N_PHASES, 0, N_PHASES)
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_diarize")
    gguf = str(d / "tiny.gguf")
    export_random_checkpoint(tiny_hparams(), gguf, seed=4)
    diar = str(d / "diarize.gguf")
    export_random_diarize_checkpoint(diar, seed=7)
    rng = np.random.default_rng(3)
    t = np.arange(24000) / 16000.0
    parts = []
    for freq in (240.0, 1100.0):
        sig = 0.45 * np.sin(2 * np.pi * freq * t) \
            + 0.1 * rng.standard_normal(len(t))
        parts += [sig, 0.005 * rng.standard_normal(16000 if not parts
                                                   else 0)]
    pcm = (np.clip(np.concatenate(parts), -1, 1) * 32767).astype("<i2")
    raw = d / "audio.pcm"
    raw.write_bytes(pcm.tobytes())
    return dict(gguf=gguf, diar=diar, raw=str(raw),
                jax_model=JaxModel.from_gguf(gguf))


def run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.fixture()
def jax_main(files, monkeypatch):
    monkeypatch.setattr(JaxModel, "from_gguf",
                        classmethod(lambda cls, path, **kw: files["jax_model"]))
    return jcli.main


@pytest.mark.parametrize("opts", [
    ["--rttm"], ["--speaker-text"], ["--json"],
    ["--json", "--rttm", "--speaker-text", "--num-speakers", "2",
     "--sub-shift", "500", "--tpu"]],
    ids=["rttm", "speaker-text", "json", "all"])
def test_cli_diarize_output_matches_jax(files, jax_main, capsys, opts):
    argv = [files["gguf"], files["raw"], "--diarize", files["diar"], *opts]
    want = run(jax_main, argv, capsys)
    got = run(tcli.main, [*argv, "--cpu"], capsys)
    assert got == want
    if "--rttm" in opts:
        assert "SPEAKER session 1 " in want
    if "--json" in opts:
        words = [json.loads(x) for x in want.splitlines()
                 if x.startswith('{"word"')]
        assert words and all("conf" not in w for w in words)
    if "--speaker-text" in opts or "--rttm" not in opts:
        assert "[spk_" in want


def test_cli_diarize_json_carries_word_confidences(files, jax_main, capsys):
    """--confidence: the word JSON of the port's CLI carries each word's
    confidence (the minimum over the last chunk's tokens, _chunk_conf),
    with the same words and times as the JAX CLI's without it."""
    argv = [files["gguf"], files["raw"], "--diarize", files["diar"], "--json"]
    want = [json.loads(x) for x in run(jax_main, argv, capsys).splitlines()
            if x.startswith('{"word"')]
    got = [json.loads(x) for x in run(
        tcli.main, [*argv, "--confidence", "--cpu"], capsys).splitlines()
        if x.startswith('{"word"')]
    assert [(w["word"], w["at"]) for w in got] \
        == [(w["word"], w["at"]) for w in want]
    assert all(0.0 <= w["conf"] <= 1.0 for w in got)
