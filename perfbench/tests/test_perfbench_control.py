"""The control at a size a CPU test holds: the reference computed with
fp8 operands in the program's place comes out not correct by the
harness's own judgement of the cell's limits, where the program comes out
correct.  ``test_perfbench_card.py`` repeats this at each cell's own size
on the card."""

import pytest

from perfbench.tests.conftest import run_cell


@pytest.mark.parametrize("cell", ["mini-narration", "mini-serve"])
def test_control_fails_a_limit(mini_root, cell):
    rc, last, err = run_cell(mini_root, cell, 2 ** 31 + 77, "--control",
                             "fp8")
    assert rc == 0, err[-3000:]
    assert last["correct"], last["checks"]
    assert last["control"]["precision"] == "fp8"
    assert last["control"]["correct"] is False, last["control"]["checks"]
    assert list(last)[-2:] == ["control", "checks"]
