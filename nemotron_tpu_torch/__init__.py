"""nemotron_tpu_torch — the streaming serving path of nemotron_tpu in PyTorch.

A port of the JAX package beside it (`nemotron_tpu/`, the reference) to
PyTorch and CUDA on an NVIDIA H100: int16 PCM -> on-device mel -> causal 8x
subsampling -> cache-aware conformer encoder -> loop-labels greedy RNNT,
driven by a batched multi-stream engine behind the same byte protocol.

The package imports torch and never jax. It reuses the jax-free modules of
`nemotron_tpu` (config, gguf reader, tokenizer, wire protocol, client),
loaded by file path (`shared.py`) so that the JAX package's __init__, which
imports jax where it is installed, never runs.
The two kernels on the path — the T=1 attention core and the mel frames —
are hand-written CUDA C++ (`csrc/`), built with nvcc at first use
(`kernels.py`); on CPU tensors their wrappers run the plain PyTorch version.
"""

from .shared.config import CacheConfig, Hparams, LatencyMode  # noqa: F401

__version__ = "0.1.0"
