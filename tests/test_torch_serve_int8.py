"""The int8 serving configuration on the CPU: Q8_0 encoder matrices and int8
K/V caches through the port's engine (k=8 backlog ticks, late joins,
starved streams with realign, prewarm) and through `serving.server.main
--quantized --kv-int8` on a tiny Q8_0 GGUF. Every transcript equals the
port's direct tick loop over the same audio with the same model (exact
tokens); the options the port does not run are still refused."""

import asyncio
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from helpers import tiny_hparams
from scripts_support import export_random_checkpoint
from test_torch_engine import (check_backlog_ticks,
                               check_prewarm_leaves_a_clean_group,
                               check_staggered_join_starve_and_resume)
from test_torch_server import direct_transcript, make_audio

from nemotron_tpu.gguf.reader import GGML_Q8_0, read_gguf
from nemotron_tpu.gguf.writer import write_gguf
from nemotron_tpu.serving.client import transcribe_file
from nemotron_tpu_torch.api import ASRModel
from nemotron_tpu_torch.ops.kvquant import is_quant
from nemotron_tpu_torch.ops.quant import is_quantized
from nemotron_tpu_torch.params import QUANT_LAYER_FIELDS, quantize_encoder_layers
from nemotron_tpu_torch.serving.server import main

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def int8_model():
    model = ASRModel.random(tiny_hparams(), seed=1, kv_int8=True)
    model.params = quantize_encoder_layers(model.params)
    return model


@pytest.mark.parametrize("check", [check_backlog_ticks,
                                   check_staggered_join_starve_and_resume,
                                   check_prewarm_leaves_a_clean_group])
def test_engine_on_int8_configuration(check):
    check(int8_model())


def q8_checkpoint(path):
    """A tiny GGUF with every encoder-layer matrix in Q8_0."""
    dense = str(path) + ".dense"
    tensors = export_random_checkpoint(tiny_hparams(), dense, seed=1)
    pat = re.compile(r"encoder\.layers\.\d+\.(feed_forward\d+|self_attn|conv)"
                     r"\.[^.]+\.weight$")
    types = {n: GGML_Q8_0 for n, a in tensors.items()
             if pat.search(n) and a.ndim == 2 and "depthwise" not in n}
    write_gguf(str(path), read_gguf(dense).kv, tensors, types)


def test_server_main_serves_quantized_kv_int8(tmp_path):
    gguf, sock = tmp_path / "q8.gguf", tmp_path / "srv.sock"
    q8_checkpoint(gguf)
    model = ASRModel.from_gguf(str(gguf), keep_quantized=True, kv_int8=True)
    assert model.kv_int8
    assert all(is_quantized(getattr(model.params.layers, f))
               for f in QUANT_LAYER_FIELDS)
    assert is_quant(model.init_stream_state(1, model.cache_config(0)).k_cache)
    audios = [make_audio(9000, seed=1), make_audio(6500, seed=2)]
    want = [direct_transcript(model, a) for a in audios]
    assert all(want), want
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "nemotron_tpu_torch.serving.server",
         str(gguf), "--device", "cpu", "--batch", "4", "--unix", str(sock),
         "--quantized", "--kv-int8"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 120
        while not sock.exists():
            assert proc.poll() is None, proc.stderr.read()
            assert time.monotonic() < deadline, "server did not listen"
            time.sleep(0.1)

        async def run():
            return await asyncio.wait_for(asyncio.gather(*[
                transcribe_file(a, unix_path=str(sock), chunk_ms=100)
                for a in audios]), timeout=120)

        got = asyncio.run(run())
    finally:
        proc.terminate()
        proc.wait(30)
    assert got == want


@pytest.mark.parametrize("flag", [["--native"], ["--diarize", "d.gguf"],
                                  ["--dp", "2"], ["--tp", "2"]])
def test_main_still_refuses_with_int8_options(flag, capsys):
    with pytest.raises(SystemExit) as e:
        main(["random", "--quantized", "--kv-int8", *flag])
    assert e.value.code == 2
    assert "not supported by the torch port" in capsys.readouterr().err
