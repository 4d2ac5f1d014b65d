"""The benchmark of nemotron_tpu_torch (the PyTorch and CUDA port) on one
NVIDIA H100: `python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` runs one cell of BENCHMARK.json once and
prints one JSON line. See portbench/core.py."""
