"""The port's streaming CLI (`python -m nemotron_tpu_torch.cli.transcribe_stream
... --cpu`) against the JAX package's `main` on the same tiny GGUF: stdout
equal for raw PCM, a .wav, stdin and --timestamps, with and without the
attention block (NEMOTRON_TPU_PALLAS_ATTN_BLOCK=1), and at right contexts
1, 6 and 13; the RTF line on stderr; the JAX CLI's --metal / --tpu taken
as no-ops; and every refused argv (a missing or malformed value, an
unknown option, a chunk of no length) exits non-zero with its message.
The diarization options are in tests/test_torch_cli_diarize.py.

The JAX package's main is given one model per GGUF (its `from_gguf`
patched to return it), so its step functions compile once per file, and
both packages run right context 0 with N_PHASES slack-buffer phases in
place of the default 8 (fewer phases to compile, a wrap every N_PHASES
chunks); right contexts 1 and 6 run with N_PHASES phases too, 13 with its
own 2."""

import io
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import tiny_hparams
from scripts_support import export_random_checkpoint

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
            for mode in (0, 1, 6):  # 13 has 2 already
                mp.setitem(cls._MODE_N_PHASES, mode, N_PHASES)
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    gguf = str(d / "tiny.gguf")
    export_random_checkpoint(tiny_hparams(), gguf, seed=4)
    rng = np.random.default_rng(0)
    t = np.arange(19200) / 16000.0
    sig = 0.4 * np.sin(2 * np.pi * 300 * t) + 0.2 * rng.standard_normal(19200)
    pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
    raw = d / "audio.pcm"
    raw.write_bytes(pcm.tobytes())
    wav = d / "audio.wav"
    data = pcm.tobytes()
    wav.write_bytes(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
                    + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000,
                                            32000, 2, 16)
                    + b"data" + struct.pack("<I", len(data)) + data)
    return dict(gguf=gguf, raw=str(raw), wav=str(wav), pcm=pcm,
                jax_model=JaxModel.from_gguf(gguf))


def run(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr()
    return out.out, out.err


@pytest.fixture()
def jax_main(files, monkeypatch):
    monkeypatch.setattr(JaxModel, "from_gguf",
                        classmethod(lambda cls, path, **kw: files["jax_model"]))
    return jcli.main


@pytest.mark.parametrize("block", [False, True], ids=["default", "block"])
def test_cli_stdout_matches_jax(files, jax_main, capsys, monkeypatch, block):
    if block:
        monkeypatch.setenv("NEMOTRON_TPU_PALLAS_ATTN_BLOCK", "1")
    for audio, extra in ((files["raw"], []), (files["wav"], []),
                         (files["raw"], ["--timestamps"]),
                         (files["raw"], ["160"])):  # chunk_ms 160
        want, _ = run(jax_main, [files["gguf"], audio, *extra], capsys)
        got, err = run(tcli.main, [files["gguf"], audio, "--cpu", *extra],
                       capsys)
        assert got == want, (audio, extra)
        assert len(want.strip()) > 10 and want.endswith("\n")
        assert "RTF: " in err and "right_context=0" in err
        assert ("attention block B3" in err) == block


@pytest.mark.parametrize("rc", ["1", "6", "13"])
def test_cli_stdout_matches_jax_at_right_context(files, jax_main, capsys,
                                                 rc):
    """Right context 1 / 6 / 13 (the 4th positional argument): the 160 ms,
    560 ms and 1.12 s chunks, with the block's variable unset."""
    want, _ = run(jax_main, [files["gguf"], files["raw"], "80", rc], capsys)
    got, err = run(tcli.main, [files["gguf"], files["raw"], "80", rc,
                               "--cpu"], capsys)
    assert got == want and len(want.strip()) > 10
    assert f"right_context={rc}" in err and "RTF: " in err


def test_cli_reads_stdin(files, jax_main, capsys, monkeypatch):
    want, _ = run(jax_main, [files["gguf"], files["raw"]], capsys)
    monkeypatch.setattr(sys, "stdin",
                        io.TextIOWrapper(io.BytesIO(files["pcm"].tobytes())))
    got, _ = run(tcli.main, [files["gguf"], "-", "--cpu"], capsys)
    assert got == want


@pytest.mark.parametrize("argv, message", [
    (["--diarize"], "--diarize needs a value"),
    (["--lang"], "--lang needs a value"),
    (["--num-speakers", "two"], "not a number"),
    (["--sub-shift", "0.5"], "not a number"),
    (["--sub-shift"], "--sub-shift needs a value"),
    (["--bogus"], "unknown option"),
    (["0"], "chunk_ms must be positive"),
])
def test_cli_refusals(files, argv, message):
    with pytest.raises(SystemExit) as e:
        tcli.main([files["gguf"], files["raw"], "--cpu", *argv])
    assert isinstance(e.value.code, str) and message in e.value.code


@pytest.mark.parametrize("flag", ["--tpu", "--metal"])
def test_cli_takes_the_jax_backend_flags_as_no_ops(files, jax_main, capsys,
                                                   flag):
    """The JAX CLI's --metal and --tpu are accepted and change nothing: the
    device stays --cpu's, and stdout is the JAX CLI's given the same argv."""
    assert tcli.parse_args(["m", "a", flag])["device"] == "cuda"
    assert tcli.parse_args(["m", "a", flag, "--cpu"])["device"] == "cpu"
    want, _ = run(jax_main, [files["gguf"], files["raw"], flag], capsys)
    got, _ = run(tcli.main, [files["gguf"], files["raw"], flag, "--cpu"],
                 capsys)
    assert got == want and len(want.strip()) > 10


def test_cli_refusal_exit_status_and_usage(files):
    cmd = [sys.executable, "-m", "nemotron_tpu_torch.cli.transcribe_stream",
           files["gguf"], files["raw"], "--cpu", "--bogus"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "unknown option --bogus" in out.stderr
    with pytest.raises(SystemExit, match="usage"):
        tcli.main([files["gguf"]])


def test_cli_does_not_fall_back_to_the_cpu(files):
    """The default device is the card: without one the CLI stops."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="--cpu"):
        tcli.main([files["gguf"], files["raw"]])
