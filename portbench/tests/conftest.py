"""Fixtures of portbench's tests. The CPU tests run tiny copies of the
benchmark's cells (tiny.py) through the whole harness on the CPU; the tests
marked `gpu` need a CUDA card and skip without one, deciding inside the
`cuda` fixture."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="session")
def tiny_suite(tmp_path_factory):
    from portbench import core
    from portbench.tests import tiny

    bench, root = tiny.build(tmp_path_factory.mktemp("tiny"))
    return core.Suite(bench, root)

