"""The port's offline CLI (`python -m nemotron_tpu_torch.cli.transcribe ...
--cpu`) against the JAX package's `cli.transcribe.main` on the same tiny
GGUF: stdout equal for raw PCM, a .wav, stdin (`-`), several files (one
past the segment cap, `name<TAB>text` lines) and --timestamps; the RTF
line on stderr; the usage error, an unknown option and --cuda without a
card exit non-zero with their messages.

The JAX package's main is given one model per GGUF (its `from_gguf`
patched to return it), so its offline functions compile once per shape."""

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
from nemotron_tpu.cli import transcribe as jcli
from nemotron_tpu_torch.cli import transcribe as tcli

torch.set_num_threads(1)


def pcm_of(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = 0.4 * np.sin(2 * np.pi * 300 * t) + 0.2 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype("<i2")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("offline_cli")
    gguf = str(d / "tiny.gguf")
    export_random_checkpoint(tiny_hparams(), gguf, seed=4)
    out = dict(gguf=gguf, jax_model=JaxModel.from_gguf(gguf))
    for name, n, seed in (("a", 19200, 0), ("b", 7000, 1), ("long", 96000, 2)):
        pcm = pcm_of(n, seed)
        (d / f"{name}.pcm").write_bytes(pcm.tobytes())
        out[name], out[name + "_pcm"] = str(d / f"{name}.pcm"), pcm
    data = out["a_pcm"].tobytes()
    wav = d / "a.wav"
    wav.write_bytes(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
                    + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000,
                                            32000, 2, 16)
                    + b"data" + struct.pack("<I", len(data)) + data)
    out["wav"] = str(wav)
    return out


def run(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr()
    return out.out, out.err


@pytest.fixture()
def jax_main(files, monkeypatch):
    monkeypatch.setattr(JaxModel, "from_gguf",
                        classmethod(lambda cls, path, **kw: files["jax_model"]))
    return jcli.main


@pytest.mark.parametrize("which", [["a"], ["wav"], ["a", "--timestamps"],
                                   ["a", "b", "long"],
                                   ["b", "long", "--timestamps"]],
                         ids=["pcm", "wav", "timestamps", "three",
                              "two-timestamps"])
def test_offline_cli_stdout_matches_jax(files, jax_main, capsys, which):
    args = [files.get(w, w) for w in which]
    want, _ = run(jax_main, [files["gguf"], *args], capsys)
    got, err = run(tcli.main, [files["gguf"], *args, "--cpu"], capsys)
    assert got == want
    names = [a for a in args if not a.startswith("--")]
    lines = want.splitlines()
    assert len(lines) == len(names) and all(ln.strip() for ln in lines)
    if len(names) > 1:
        assert [ln.split("\t")[0] for ln in lines] == names
    assert ("{" in want) == ("--timestamps" in which)
    assert "RTF: " in err and "audio: " in err


def test_offline_cli_reads_stdin(files, jax_main, capsys, monkeypatch):
    """`-` reads stdin once; a second `-` reuses what it read."""
    want, _ = run(jax_main, [files["gguf"], files["a"], files["a"]], capsys)
    monkeypatch.setattr(sys, "stdin",
                        io.TextIOWrapper(io.BytesIO(files["a_pcm"].tobytes())))
    got, _ = run(tcli.main, [files["gguf"], "-", "-", "--cpu"], capsys)
    assert [ln.split("\t")[1] for ln in got.splitlines()] \
        == [ln.split("\t")[1] for ln in want.splitlines()]


@pytest.mark.parametrize("argv, message", [
    ([], "usage: transcribe"),
    (["m.gguf"], "usage: transcribe"),
    (["m.gguf", "a.pcm", "--bf16"], "unknown option --bf16"),
])
def test_offline_cli_refusals(argv, message):
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert message in str(e.value)


def test_offline_cli_defaults_to_the_card(files):
    """Without --cpu the CLI asks for the card: where there is none it
    exits non-zero with its message, in a process of its own."""
    assert tcli.parse_args([files["gguf"], files["a"]])["device"] == "cuda"
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "-m", "nemotron_tpu_torch.cli.transcribe",
         files["gguf"], files["a"]], capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and not out.stdout
    assert "needs a CUDA card" in out.stderr
