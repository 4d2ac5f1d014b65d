"""Entry point: `python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1> [--control]`, from the root of a checkout.

The caches of what the run builds stay at fixed paths inside the checkout
(the program keeps its kernel library in nemotron_tpu_torch/_build/), so a
second run of a cell finds them built; they are set before torch is
imported."""

from __future__ import annotations

import os
import sys
import time

T_START = time.perf_counter()  # process start, as near as Python sees it

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(_CHECKOUT, ".portbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")


def main() -> int:
    from portbench import core

    return core.main(sys.argv[1:], t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
