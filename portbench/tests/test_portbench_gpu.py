"""On the card, at sizes a test run holds: every cell of BENCHMARK.json
runs correct, and its control (the reference in fp8 in the program's
place, `--control`) comes out not correct. Run on the card with

    python3 -m pytest portbench/tests -m gpu -q
"""

from __future__ import annotations

import pytest

from portbench import core, variants
from portbench.tests import tiny

SMALL = {
    "q8-r0-live": {"sizes": {"streams": 96, "slots": 256},
                   "traffic": {"warm_s": 4, "sample_streams": 6}},
    "q8-r13-backlog": {"sizes": {"slots": 64},
                       "traffic": {"warm_s": 3, "sample_streams": 6}},
    "bf16-r0-backlog": {"sizes": {"slots": 128},
                        "traffic": {"warm_s": 3, "sample_streams": 6}},
    "bf16-offline": {"traffic": {"files": 4, "length_s": [60, 200],
                                 "sample_files": 4}},
}


@pytest.fixture(scope="module")
def small_suite(tmp_path_factory):
    bench, root = variants.shrunk(tmp_path_factory.mktemp("small"), SMALL)
    return core.Suite(bench, root)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(SMALL))
def test_cell_is_correct_and_its_control_is_not(cuda, small_suite, capsys,
                                                cell):
    line = tiny.run_cell(small_suite, cell, capsys, seed=2 ** 31 + 101,
                         seconds=4, device="cuda")
    assert line["correct"] is True, line["check"]
    assert line["device"]["platform"] == "gpu"
    control = tiny.run_cell(small_suite, cell, capsys, seed=2 ** 31 + 101,
                            seconds=4, device="cuda", control=True)
    assert control["correct"] is False, control["check"]
