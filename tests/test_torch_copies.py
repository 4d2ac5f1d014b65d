"""The port's own copies of the JAX package's jax-free modules against the
originals: config, the GGUF reader and writer, the tokenizer, the wire
protocol and client, the native host runtime, the native ingest
bindings (with their C++ source, byte for byte), the wav reader, the
tensor dump appenders, and the replica launcher and routed client (which
launch the port's server module, SERVER_MODULE, where the original names
its own). The port
may import nothing of `nemotron_tpu`, so it keeps these copies at the same
module paths; they must behave byte for byte as the originals. Each test
feeds the same inputs to both and compares what comes out exactly."""

import ast
import dataclasses
import importlib
import struct
from pathlib import Path

import numpy as np
import pytest

from helpers import tiny_hparams
from scripts_support import export_random_checkpoint

from nemotron_tpu import config as jconfig
from nemotron_tpu import native as jnative
from nemotron_tpu.audio import wavio as jwavio
from nemotron_tpu.gguf import reader as jreader
from nemotron_tpu.gguf import writer as jwriter
from nemotron_tpu.serving import protocol as jprotocol
from nemotron_tpu.text import tokenizer as jtokenizer
from nemotron_tpu_torch import config as tconfig
from nemotron_tpu_torch import native as tnative
from nemotron_tpu_torch.audio import wavio as twavio
from nemotron_tpu_torch.gguf import reader as treader
from nemotron_tpu_torch.gguf import writer as twriter
from nemotron_tpu_torch.serving import protocol as tprotocol
from nemotron_tpu_torch.text import tokenizer as ttokenizer

ROOT = Path(__file__).resolve().parents[1]

# module path under both packages -> the top-level names the port's copy
# may define differently (only where it builds and loads its host library)
COPIES = {
    "config": set(),
    "gguf.reader": set(),
    "gguf.writer": set(),
    "text.tokenizer": set(),
    "serving.protocol": set(),
    "serving.client": set(),
    "native": {"_PKG", "_SRC", "_SO", "_build"},
    # the port builds into its _build/, records why a build failed and
    # raises it where a server asks for the native path
    "serving.ingest": {"_PKG", "_SRC", "_SO", "_load", "_load_error",
                       "require_native_ingest"},
    "audio.wavio": set(),
    "utils.dump": set(),
    # the server module each replica runs, a constant in the port's copy
    "serving.replicas": {"SERVER_MODULE"},
}

# module path -> (AST dump in the original, its stand-in in the copy)
RENAMED = {
    "serving.replicas": (
        ast.dump(ast.Constant("nemotron_tpu.serving.server")),
        ast.dump(ast.Name("SERVER_MODULE", ast.Load()))),
}


def _top_level(path: Path) -> dict[str, str]:
    """Each top-level definition or assignment of a module, as an AST dump
    without the module docstring and the import lines."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
            continue  # docstring
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [ast.unparse(t) for t in node.targets]
        elif isinstance(node, ast.AnnAssign):
            names = [ast.unparse(node.target)]
        else:
            names = [ast.unparse(node)[:40]]
        for n in names:
            out[n] = ast.dump(node)
    return out


@pytest.mark.parametrize("mod", sorted(COPIES))
def test_copy_has_the_originals_code(mod):
    """Every definition of the original is in the copy, unchanged, apart
    from the imports and the host library's paths."""
    rel = mod.replace(".", "/") + ".py"
    want = _top_level(ROOT / "nemotron_tpu" / rel)
    got = _top_level(ROOT / "nemotron_tpu_torch" / rel)
    if mod in RENAMED:
        old, new = RENAMED[mod]
        assert any(old in d for d in want.values())
        want = {n: d.replace(old, new) for n, d in want.items()}
    allowed = COPIES[mod]
    assert set(want) - allowed <= set(got)
    changed = [n for n in want if n not in allowed and got[n] != want[n]]
    assert not changed
    assert set(got) - set(want) <= allowed
    # the copy imports within the port only
    port = importlib.import_module(f"nemotron_tpu_torch.{mod}")
    assert port.__name__.startswith("nemotron_tpu_torch.")


@pytest.mark.parametrize("mode", list(jconfig.LatencyMode))
@pytest.mark.parametrize("tiny", [False, True])
def test_config_values_per_mode(mode, tiny, monkeypatch):
    monkeypatch.delenv("NEMOTRON_TPU_N_PHASES", raising=False)
    assert [(m.name, int(m)) for m in jconfig.LatencyMode] \
        == [(m.name, int(m)) for m in tconfig.LatencyMode]
    jhp = tiny_hparams() if tiny else jconfig.Hparams()
    thp = tconfig.Hparams(**dataclasses.asdict(jhp))
    assert dataclasses.asdict(thp) == dataclasses.asdict(jhp)
    jc = jconfig.CacheConfig.for_mode(int(mode), jhp)
    tc = tconfig.CacheConfig.for_mode(tconfig.LatencyMode(int(mode)), thp)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for prop in ("chunk_mel_frames", "shift_mel_frames", "valid_out_len",
                 "chunk_samples", "shift_samples", "latency_ms"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    for meth in ("chunk_len", "cache_buf_len", "kv_len", "pos_len"):
        assert getattr(tc, meth)(thp) == getattr(jc, meth)(jhp), meth
    for prop in ("subsampled_mels", "subsampling_flat_dim"):
        assert getattr(thp, prop) == getattr(jhp, prop), prop
    assert tconfig.MAX_SYMBOLS_PER_STEP == jconfig.MAX_SYMBOLS_PER_STEP
    assert dataclasses.asdict(tconfig.CacheConfig()) \
        == dataclasses.asdict(jconfig.CacheConfig())


_TYPES = {"f32": None, "f16": jreader.GGML_F16, "q8_0": jreader.GGML_Q8_0,
          "q4_0": jreader.GGML_Q4_0}


def _checkpoint(tmp_path, kind, prompts=0):
    """A synthetic GGUF with its encoder-layer matrices of one type (Q4_0
    only where the input width is a multiple of 64)."""
    hp = tiny_hparams(num_prompts=prompts)
    path = str(tmp_path / f"{kind}.gguf")
    tensors = export_random_checkpoint(hp, path, seed=11)
    ggml = _TYPES[kind]
    if ggml is None:
        return path, tensors, None
    step = 64 if ggml == jreader.GGML_Q4_0 else 32
    types = {n: ggml for n, a in tensors.items()
             if n.startswith("encoder.layers.") and a.ndim == 2
             and a.shape[-1] % step == 0}
    jwriter.write_gguf(path, jreader.read_gguf(path).kv, tensors, types)
    return path, tensors, types


@pytest.mark.parametrize("kind", sorted(_TYPES))
def test_read_gguf_gives_equal_kv_and_tensors(tmp_path, kind):
    path, _, _ = _checkpoint(tmp_path, kind, prompts=4)
    jg, tg = jreader.read_gguf(path), treader.read_gguf(path)
    assert tg.kv == jg.kv and tg.data_offset == jg.data_offset
    assert {n: dataclasses.asdict(i) for n, i in tg.tensors.items()} \
        == {n: dataclasses.asdict(i) for n, i in jg.tensors.items()}
    jt, tt = jg.load_all(), tg.load_all()
    assert list(tt) == list(jt)
    for name in jt:
        assert tt[name].dtype == jt[name].dtype
        np.testing.assert_array_equal(tt[name], jt[name])
        assert tg.raw_tensor(name) == jg.raw_tensor(name)
    for ggml in (jreader.GGML_F32, jreader.GGML_F16, jreader.GGML_Q8_0,
                 jreader.GGML_Q4_0):
        assert treader.tensor_nbytes(4096, ggml) \
            == jreader.tensor_nbytes(4096, ggml)


@pytest.mark.parametrize("kind", sorted(_TYPES))
def test_write_gguf_gives_identical_bytes(tmp_path, kind):
    src, tensors, types = _checkpoint(tmp_path, kind)
    kv = dict(jreader.read_gguf(src).kv, **{"x.neg": -3, "x.f": 0.25,
                                            "x.ints": [1, -2, 3]})
    a, b = tmp_path / "jax.gguf", tmp_path / "port.gguf"
    jwriter.write_gguf(str(a), kv, tensors, types)
    twriter.write_gguf(str(b), kv, tensors, types)
    assert a.read_bytes() == b.read_bytes()
    arr = np.random.default_rng(3).standard_normal((4, 128)).astype(np.float32)
    assert twriter.quantize_q8_0(arr) == jwriter.quantize_q8_0(arr)
    assert twriter.quantize_q4_0(arr) == jwriter.quantize_q4_0(arr)


def test_tokenizer_decodes_equal():
    vocab = [f"▁w{i}" if i % 3 == 0 else f"p{i}" for i in range(32)]
    vocab[5] = "<en-US>"
    jt, tt = jtokenizer.Tokenizer(vocab), ttokenizer.Tokenizer(vocab)
    rng = np.random.default_rng(4)
    ids = rng.integers(-2, 36, 60).tolist()  # out-of-range ids included
    frames = rng.integers(0, 400, 60).tolist()
    assert len(tt) == len(jt)
    assert tt.decode(ids) == jt.decode(ids)
    assert tt.decode(ids, timestamp_words=True, frames=frames) \
        == jt.decode(ids, timestamp_words=True, frames=frames)
    assert [tt.piece(i) for i in ids] == [jt.piece(i) for i in ids]
    assert ttokenizer.TimedToken(3, 17).to_seconds() \
        == jtokenizer.TimedToken(3, 17).to_seconds()


def test_protocol_frames_are_equal_bytes():
    ops = [n for n in dir(jprotocol) if n.startswith("OP_")]
    assert ops == [n for n in dir(tprotocol) if n.startswith("OP_")]
    for name in ops + ["HEADER_SIZE", "MAX_SEGMENT_SAMPLES",
                       "DEFAULT_MEM_BUDGET"]:
        assert getattr(tprotocol, name) == getattr(jprotocol, name), name
    pcm = np.arange(-40, 40, dtype="<i2").tobytes()
    for name in ops:
        op = getattr(jprotocol, name)
        for payload in (b"", pcm, "héllo ▁wörld"):
            assert tprotocol.pack(op, 7, payload) \
                == jprotocol.pack(op, 7, payload)
        obj = {"lang": "de-DE", "right_context": 6, "id": 2 ** 31}
        assert tprotocol.pack_json(op, 2 ** 32 - 1, obj) \
            == jprotocol.pack_json(op, 2 ** 32 - 1, obj)
    assert tprotocol.HEADER.unpack(jprotocol.pack(0x83, 9, b"ab")[:9]) \
        == (0x83, 9, 2)


def _wav(path, samples, rate=16000):
    n_ch = samples.shape[1] if samples.ndim == 2 else 1
    data = np.ascontiguousarray(samples, "<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, n_ch, rate, rate * 2 * n_ch, 2 * n_ch, 16)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + 16 + 8 + 8 + len(data))
                + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", 16) + fmt)
        f.write(b"LIST" + struct.pack("<I", 3) + b"abc\x00")  # odd, padded
        f.write(b"data" + struct.pack("<I", len(data)) + data)


@pytest.mark.parametrize("channels", [1, 2])
def test_read_wav_and_preemph_equal(tmp_path, channels):
    rng = np.random.default_rng(5 + channels)
    shape = (3000, channels) if channels > 1 else (3000,)
    samples = rng.integers(-32768, 32767, shape).astype(np.int16)
    path = str(tmp_path / "a.wav")
    _wav(path, samples)
    (ja, jr), (ta, tr) = jwavio.read_wav(path), twavio.read_wav(path)
    assert tr == jr == 16000 and ta.dtype == ja.dtype
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(twavio.maybe_read_audio(path),
                                  jwavio.maybe_read_audio(path))
    assert tnative.have_native() == jnative.have_native()
    for audio in (ja, ja.astype(np.float32) / 32768.0):
        (jo, jc), (to, tc) = (jnative.pcm_to_f32_preemph(audio, 0.97, 0.125),
                              tnative.pcm_to_f32_preemph(audio, 0.97, 0.125))
        np.testing.assert_array_equal(to, jo)
        assert tc == jc
    buf = rng.standard_normal(2048).astype(np.float32)
    np.testing.assert_array_equal(tnative.frame_signal(buf, 10, 160, 512),
                                  jnative.frame_signal(buf, 10, 160, 512))


def test_host_library_builds_inside_the_port():
    """The port's host library comes from its own source into its own
    git-ignored build directory, never into the JAX package's `native/`."""
    assert tnative.have_native()
    pkg = ROOT / "nemotron_tpu_torch"
    assert Path(tnative._SRC) == pkg / "csrc" / "host" / "nemotron_host.cpp"
    assert Path(tnative._SO).parent == pkg / "_build"
    assert Path(tnative._SO).is_file()
    assert Path(tnative._SRC).read_text().split("#include", 1)[1] \
        == (ROOT / "native" / "nemotron_host.cpp").read_text().split(
            "#include", 1)[1]


def test_ingest_library_builds_inside_the_port():
    """The port's ingest server is the JAX package's C++ source byte for
    byte, built from the port's own copy into its git-ignored build
    directory; the two _load functions differ only in the build directory
    and in keeping the failure's message."""
    from nemotron_tpu.serving import ingest as jingest
    from nemotron_tpu_torch.serving import ingest as tingest

    pkg = ROOT / "nemotron_tpu_torch"
    assert Path(tingest._SRC) == pkg / "csrc" / "host" / "ingest_server.cpp"
    assert Path(tingest._SRC).read_bytes() \
        == (ROOT / "native" / "ingest_server.cpp").read_bytes()
    assert tingest.have_native_ingest() == jingest.have_native_ingest()
    assert Path(tingest._SO).parent == pkg / "_build"
    assert Path(tingest._SO).is_file()
    assert (tingest.EV_START, tingest.EV_SET_LANG, tingest.EV_END,
            tingest.EV_DROP) == (jingest.EV_START, jingest.EV_SET_LANG,
                                 jingest.EV_END, jingest.EV_DROP)
