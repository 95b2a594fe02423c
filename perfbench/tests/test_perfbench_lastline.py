"""The result line: exactly its required keys, the compared numbers
last; and a whole CPU run of each mini cell, sound, prints one."""

import json

import pytest

from perfbench.harness import judge, result_line
from perfbench.tests.conftest import MINI_CELLS, run_cell

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def test_result_line_keys():
    ok, checks = judge({"a": 0.1, "b": None}, {"a": 0.2, "b": 1.0})
    assert not ok and checks["a"] == {"value": 0.1, "limit": 0.2}
    line = json.loads(result_line(True, 3, 0, {}, {"platform": "gpu"},
                                  checks))
    assert list(line) == REQUIRED + ["checks"]
    line = json.loads(result_line(True, 3, 0, {}, {}, checks,
                                  {"device_ops": [], "idle_gaps": []}))
    assert list(line) == REQUIRED + ["breakdown", "checks"]


@pytest.mark.parametrize("cell", sorted(MINI_CELLS))
def test_sound_run_is_correct(mini_root, cell):
    rc, last, err = run_cell(mini_root, cell, 2 ** 31 + 11)
    assert rc == 0, err[-3000:]
    assert last["correct"], last["checks"]
    assert last["attempted"] > 0 and last["failed"] == 0
    assert "setup_s" in last["metrics"] and len(last["metrics"]) == 2
    assert list(last)[-1] == "checks"
    assert err.rstrip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("cell", sorted(MINI_CELLS))
def test_traced_run_reports_its_window(mini_root, cell):
    rc, last, err = run_cell(mini_root, cell, 2 ** 31 + 12, trace=1,
                             seconds=6.0)
    assert rc == 0, err[-3000:]
    assert last["correct"], last["checks"]
    assert last["device"]["window_s"] > 0
    assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "setup_s" not in last["metrics"]
