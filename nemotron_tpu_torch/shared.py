"""The jax-free modules the port shares with the JAX package, loaded without
importing that package.

`import nemotron_tpu.config` would first run nemotron_tpu/__init__.py, which
imports jax wherever jax is installed. So the port loads each shared file
by its path, under a name of its own (`nemotron_tpu_torch.shared.<name>`):
importing the port imports neither jax nor `nemotron_tpu`, and the code is
still one copy.

    config       Hparams, CacheConfig, LatencyMode, MAX_SYMBOLS_PER_STEP
    gguf         the GGUF reader (read_gguf, GGML_* type codes)
    gguf_writer  the GGUF writer (write_gguf), for synthetic checkpoints
    tokenizer    Tokenizer
    protocol     the server's byte protocol
    client       the asyncio client of that protocol
    native       pcm_to_f32_preemph (the host frontend's pre-emphasis)
    wavio        read_wav

These classes are objects of their own: an `Hparams` of the JAX package is
not an instance of `shared.config.Hparams`, though it has the same fields,
and the port reads only the fields.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_REF = Path(__file__).resolve().parent.parent / "nemotron_tpu"


def _load(name: str, rel_path: str):
    full = f"{__name__}.{name}"
    if full in sys.modules:
        return sys.modules[full]
    spec = importlib.util.spec_from_file_location(full, _REF / rel_path)
    if spec is None:
        raise ImportError(f"{full}: cannot load {_REF / rel_path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


config = _load("config", "config.py")
gguf = _load("gguf", "gguf/reader.py")
sys.modules[f"{__name__}.reader"] = gguf  # the writer's `from .reader import`
gguf_writer = _load("gguf_writer", "gguf/writer.py")
tokenizer = _load("tokenizer", "text/tokenizer.py")
protocol = _load("protocol", "serving/protocol.py")
client = _load("client", "serving/client.py")  # `from . import protocol`
native = _load("native", "native.py")
wavio = _load("wavio", "audio/wavio.py")
