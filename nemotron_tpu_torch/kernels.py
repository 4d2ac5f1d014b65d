"""Build, load and launch the hand-written CUDA kernels in `csrc/`.

Every `csrc/*.cu` file is compiled by nvcc into ONE shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/libnemotron_kernels_<hash>.so csrc/*.cu

The library is keyed by a hash of the sources and flags, built at first use
into `_build/` (git-ignored) and loaded with ctypes. Each exported launcher
takes device pointers, sizes and the CUDA stream, launches on that stream
without synchronising, and returns `cudaGetLastError()`; `Kernel.launch`
raises on a non-zero code. There is no fallback: a failed build or launch
raises to the caller.

`Kernel.launches` counts successful launches of that kernel, so a run can
show that its main path went through the kernel (chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# exported symbol -> argtypes (pointers and the stream as c_void_p, or
# ctypes would pass them as 32-bit ints and cut them)
_SIGNATURES = {
    # q, k_new, v_new, pos_mask, k_buf, v_buf, out, batch*heads, s_buf,
    # d_head, scale, stream
    "t1_attention_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "t1_attention_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    # buf, window512, dft_cos, dft_sin, fb_t, out, batch, n_buf, n_frames,
    # n_mels, stream
    "mel_frames_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}  # path, seconds, cached, ptxas log of the last build


def _find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels in nemotron_tpu_torch/csrc cannot be built")


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnemotron_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the hashed shared library unless it exists.
    Concurrent builders write private temp files and rename atomically."""
    out = library_path()
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources()]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=False, log=proc.stdout + proc.stderr)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


class Kernel:
    """One hand-written kernel: its launchers in the library and the count
    of its launches (incremented only after a launch returned success)."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source      # path in the repo
        self.replaces = replaces  # the TPU kernel it ports (file:line)
        self.launches = 0

    def launch(self, symbol: str, *args) -> None:
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(library(), symbol)(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{symbol}: CUDA launch failed with error {err}")
        self.launches += 1


T1_ATTENTION = Kernel(
    "t1_attention", "nemotron_tpu_torch/csrc/t1_attention.cu",
    "nemotron_tpu/ops/attn_pallas.py:57")
MEL_FRAMES = Kernel(
    "mel_frames", "nemotron_tpu_torch/csrc/mel_frames.cu",
    "nemotron_tpu/ops/mel_pallas.py:74")
KERNELS = (T1_ATTENTION, MEL_FRAMES)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0
