"""The port and chip_smoke.py never import jax or the JAX package: every
module of nemotron_tpu_torch and chip_smoke import in a process in which
`import jax` fails, and, where jax is installed, leave neither jax nor
`nemotron_tpu` in sys.modules; no source file of the port names jax; the
kernel wrappers given CPU tensors take their plain versions without
building or launching. The walk covers every module of the port, the
session, frontend and both CLI modules, the diarization package and the
native ingest server, the device mesh, the replicas and the dump
appenders included. No file of the port or
chip_smoke.py names a path into `nemotron_tpu/` or `native/` (the port
keeps its own copies of the modules it shares with the JAX package), and
the port's entry points default to the card: without one, a model that
asks for no device raises instead of falling back to the CPU."""

import ast
import importlib.util

import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from helpers import tiny_hparams

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "nemotron_tpu_torch"

CHILD = textwrap.dedent("""
    import importlib, pkgutil, sys
    import numpy as np
    if "--block-jax" in sys.argv:
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
    import torch
    import nemotron_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        nemotron_tpu_torch.__path__, "nemotron_tpu_torch.")]
    assert "nemotron_tpu_torch.cli.transcribe" in names
    for mod in ("diarize.audio", "diarize.nets", "diarize.params",
                "diarize.cluster", "diarize.pipeline", "serving.ingest",
                "serving.native_server", "parallel.mesh",
                "serving.replicas", "utils.dump"):
        assert "nemotron_tpu_torch." + mod in names, mod
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    loaded = [m for m, v in sys.modules.items() if v is not None]
    assert not [m for m in loaded if m.split(".")[0] in
                ("jax", "jaxlib", "nemotron_tpu")], loaded

    from nemotron_tpu_torch import kernels
    from nemotron_tpu_torch.audio.frontend import mel_full
    from nemotron_tpu_torch.cli.transcribe_stream import parse_args
    from nemotron_tpu_torch.ops.attn_block import t1_attention_block
    from nemotron_tpu_torch.ops.attn_kernel import t1_attention_core
    from nemotron_tpu_torch.ops.kvquant import quantize_kv
    from nemotron_tpu_torch.ops.mel_kernel import mel_frames
    from nemotron_tpu_torch.ops.quant import (linear_q4, linear_q8,
                                              quantize_q4, quantize_q8)
    q = torch.randn(2, 2, 8)
    kb = torch.randn(2, 2, 5, 8)
    pm = torch.zeros(2, 2, 6)
    assert t1_attention_core(q, q, q, pm, kb, kb).shape == (2, 2, 8)
    kq = quantize_kv(kb)
    assert t1_attention_core(q, q, q, pm, kq, kq).shape == (2, 2, 8)
    buf = torch.randn(2, 672)
    assert mel_frames(buf, torch.ones(512), torch.rand(4, 257), 2).shape \\
        == (2, 2, 4)
    w = torch.randn(6, 64).numpy()
    assert linear_q8(torch.randn(3, 64), quantize_q8(w)).shape == (3, 6)
    assert linear_q4(torch.randn(3, 64), quantize_q4(w)).shape == (3, 6)
    x, w = torch.randn(2, 16), torch.randn(16, 16)
    out, kn, vn = t1_attention_block(
        x, torch.ones(16), torch.zeros(16), w, w, w, w, torch.zeros(2, 8),
        torch.zeros(2, 8), torch.zeros(2, 8, 6), torch.zeros(2, 6), kb, kb,
        2, 8)
    assert out.shape == (2, 16) and kn.shape == vn.shape == (2, 2, 8)
    assert t1_attention_block(
        x, torch.ones(16), torch.zeros(16), w, w, w, w, torch.zeros(2, 8),
        torch.zeros(2, 8), torch.zeros(2, 8, 6), torch.zeros(2, 6), kq, kq,
        2, 8)[0].shape == (2, 16)
    assert mel_full(np.zeros(1600, np.int16), np.ones((4, 257), np.float32),
                    np.ones(400, np.float32)).shape == (9, 4)
    assert parse_args(["m.gguf", "-"])["device"] == "cuda"
    from nemotron_tpu_torch.cli import transcribe
    assert transcribe.parse_args(["m.gguf", "-"])["device"] == "cuda"
    from nemotron_tpu_torch.diarize.cluster import nmesc_cluster
    emb = np.random.default_rng(0).standard_normal((8, 16))
    assert nmesc_cluster(emb).labels.shape == (8,)
    from nemotron_tpu_torch.parallel.mesh import make_mesh
    assert make_mesh(2, 2, devices=["cpu"] * 4).shape == {"dp": 2, "tp": 2}
    assert len(kernels.KERNELS) == 6
    assert [k.launches for k in kernels.KERNELS] == [0] * 6
    assert kernels._lib is None  # nothing was built or loaded
    print("ok", len(names))
""")


def run_child(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", CHILD, *args], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[-1])
    assert n_modules >= 20


def test_port_and_smoke_import_without_jax():
    run_child("--block-jax")


def test_port_and_smoke_never_import_jax_where_it_is_installed():
    assert importlib.util.find_spec("jax") is not None
    run_child()


def test_no_source_file_names_jax():
    # jax itself, or the JAX package (whose __init__ imports jax)
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|nemotron_tpu)\b", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 15
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders


# calls that load, open, build or run a file or module by its name
_LOADERS = {"spec_from_file_location", "SourceFileLoader", "run_path",
            "import_module", "__import__", "exec", "open", "Path", "join",
            "CDLL", "fromfile", "run", "Popen", "check_output", "load"}
_JAX_ROOTS = ("nemotron_tpu", "native")


def _names_jax_path(value) -> bool:
    if not isinstance(value, str):
        return False
    head = re.split(r"[/.]", value.lstrip("./"), maxsplit=1)[0]
    return head in _JAX_ROOTS and not value.startswith("nemotron_tpu_torch")


def _path_offences(tree) -> list[str]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if name in ("spec_from_file_location", "SourceFileLoader",
                        "run_path"):
                out.append(f"{name}()")
            elif name in _LOADERS:
                out += [f"{name}({c.value!r})"
                        for arg in [*node.args, *(k.value for k in
                                                   node.keywords)]
                        for c in ast.walk(arg)
                        if isinstance(c, ast.Constant)
                        and _names_jax_path(c.value)]
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            out += [f"/ {c.value!r}" for c in (node.left, node.right)
                    if isinstance(c, ast.Constant) and _names_jax_path(c.value)]
        elif isinstance(node, ast.Constant) and node.value in _JAX_ROOTS:
            out.append(repr(node.value))  # a bare path component
    return out


def test_no_file_names_a_path_into_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert not (PKG / "shared.py").exists()
    offenders = {str(f.relative_to(ROOT)): bad for f in files
                 if (bad := _path_offences(ast.parse(f.read_text())))}
    assert not offenders
    # the check itself sees the forms a path into the JAX package takes
    for probe in ('spec = importlib.util.spec_from_file_location("m", p)',
                  'ref = Path(__file__).parent.parent / "nemotron_tpu"',
                  'src = os.path.join(root, "native", "nemotron_host.cpp")',
                  'lib = ctypes.CDLL("native/libnemotron_host.so")',
                  'cfg = open("nemotron_tpu/config.py").read()',
                  'mod = importlib.import_module("nemotron_tpu.config")'):
        assert _path_offences(ast.parse(probe)), probe


def test_default_device_is_the_card():
    """ASRModel.random with no device: on the card where there is one, and
    an error where there is none (no fallback to the CPU)."""
    from nemotron_tpu_torch.api import ASRModel
    from nemotron_tpu_torch.params import random_params

    if torch.cuda.is_available():
        assert ASRModel.random(tiny_hparams()).device.type == "cuda"
        return
    for make in (lambda: ASRModel.random(tiny_hparams()),
                 lambda: random_params(tiny_hparams())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
