"""The timed path broken underneath a whole run: ``correct`` comes out
false for every fault the cell can have (a changed answer, half a batch
left out)."""

import pytest

from perfbench.tests.conftest import run_cell


@pytest.mark.parametrize("cell,fault", [
    ("mini-narration", "alter_answer"),
    ("mini-narration", "half_batch"),
    ("mini-serve", "alter_answer"),
])
def test_fault_is_not_correct(mini_root, cell, fault):
    rc, last, err = run_cell(mini_root, cell, 2 ** 32 + 5, "--fault",
                             fault)
    assert rc == 0, err[-3000:]
    assert not last["correct"], last["checks"]
