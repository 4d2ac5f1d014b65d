"""The port and chip_smoke.py never import jax or the JAX package: every
module of nemotron_tpu_torch and chip_smoke import in a process in which
`import jax` fails, and, where jax is installed, leave neither jax nor
`nemotron_tpu` in sys.modules; no source file of the port names jax; the
kernel wrappers given CPU tensors take their plain versions without
building or launching."""

import importlib.util

import os
import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "nemotron_tpu_torch"

CHILD = textwrap.dedent("""
    import importlib, pkgutil, sys
    if "--block-jax" in sys.argv:
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
    import torch
    import nemotron_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        nemotron_tpu_torch.__path__, "nemotron_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    loaded = [m for m, v in sys.modules.items() if v is not None]
    assert not [m for m in loaded if m.split(".")[0] in
                ("jax", "jaxlib", "nemotron_tpu")], loaded

    from nemotron_tpu_torch import kernels
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
    assert [k.launches for k in kernels.KERNELS] == [0] * 4
    assert kernels._lib is None  # nothing was built or loaded
    print("ok", len(names))
""")


def run_child(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", CHILD, *args], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[-1])
    assert n_modules >= 15


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
