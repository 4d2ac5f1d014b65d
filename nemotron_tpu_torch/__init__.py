"""nemotron_tpu_torch — the streaming serving path of nemotron_tpu in PyTorch.

A port of the JAX package beside it (`nemotron_tpu/`, the reference) to
PyTorch and CUDA on an NVIDIA H100: int16 PCM -> on-device mel -> causal 8x
subsampling -> cache-aware conformer encoder -> loop-labels greedy RNNT,
driven by a batched multi-stream engine behind the same byte protocol.

The package imports torch and never jax, and nothing of `nemotron_tpu`: it
keeps its own copies of the JAX package's jax-free modules at the same
module paths (config, gguf reader and writer, tokenizer, wire protocol,
client, native host runtime, wav reader). Its entry points run on the card
unless the caller asks for the CPU.
The two kernels on the path — the T=1 attention core and the mel frames —
are hand-written CUDA C++ (`csrc/`), built with nvcc at first use
(`kernels.py`); on CPU tensors their wrappers run the plain PyTorch version.
"""

from .config import CacheConfig, Hparams, LatencyMode  # noqa: F401

__version__ = "0.1.0"
