"""On the card, at each cell's own size: the control (the reference with
fp8 operands in the program's place) comes out not correct by the
harness's judgement of the cell's limits, while the program comes out
correct, on three seeds.  Run with ``python -m pytest -q perfbench/tests
-m cuda`` on a machine with a card; each case is whole runs of the cell,
so it takes minutes."""

import json

import pytest

from perfbench.harness import load_manifest
from perfbench.tests.conftest import REPO

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in load_manifest(REPO)["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 32 + 202, 7])
def test_control_fails_where_the_program_passes(card, cell, seed, capfd):
    from perfbench import run

    assert run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     "8", "--trace", "0", "--control", "fp8"]) == 0
    out = capfd.readouterr().out
    last = json.loads(out.strip().splitlines()[-1])
    assert last["correct"], last["checks"]
    assert last["control"]["correct"] is False, last["control"]["checks"]
