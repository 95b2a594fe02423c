"""BENCHMARK.json against the benchmark format's rules, and every
cell's files found by name; a cell added as files alone loads."""

import json
import os
import re
import shutil

from perfbench.harness import Cell, load_manifest, metric_reader
from perfbench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_manifest_keys_and_names():
    m = load_manifest(REPO)
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        for text in (c["source"], c["why"]):
            assert 0 < len(text) <= 200 and not set(text) & set("\t\n")
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    for metric in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(metric["name"]), metric["name"]
        assert UNIT.match(metric["unit"]), metric["unit"]
        assert metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES
    for metric in m["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    for metric in m["per_layer"]:
        assert metric["moves"] in {e["name"] for e in m["end_to_end"]}
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
    assert "setup_s" in {e["name"] for e in m["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads") for x in m[k]]
    names += [x["name"] for k in ("end_to_end", "per_layer") for x in m[k]]
    assert len(names) == len(set(names))


def test_every_cell_finds_its_files():
    m = load_manifest(REPO)
    for w in m["workloads"]:
        cell = Cell(m, w["name"], REPO)
        assert cell.driver().run
        assert cell.limits
        assert {e["name"] for e in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for metric in cell.per_layer:
            assert callable(metric_reader(metric["name"], REPO))


def test_readers_return_nothing_without_data():
    m = load_manifest(REPO)
    for metric in m["per_layer"]:
        assert metric_reader(metric["name"], REPO)({}) is None


def test_a_cell_added_as_files_loads(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = load_manifest(REPO)
    with open(os.path.join(root, "perfbench", "traffic",
                           "narration-mixed.json"), "w") as fh:
        json.dump({"driver": "narration_batch", "batch": 64,
                   "phonemes": [10, 500], "warm_calls": 2,
                   "traced_calls": 3, "sample": 12}, fh)
    with open(os.path.join(root, "perfbench", "limits",
                           "tiny-narration-mixed.json"), "w") as fh:
        json.dump({"wav_err": 0.1}, fh)
    m["workloads"].append({"name": "tiny-narration-mixed",
                           "config": "es-tiny-ljv2",
                           "traffic": "narration-mixed", "chips": 1,
                           "why": "mixed lengths"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if "tiny-narration-batch" in metric.get("workloads", []):
            metric["workloads"].append("tiny-narration-mixed")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(m, fh)
    cell = Cell(load_manifest(root), "tiny-narration-mixed", root)
    assert cell.mix["phonemes"] == [10, 500]
    assert {e["name"] for e in cell.end_to_end} == {
        "narration_speech_s_per_s", "setup_s"}
    assert "k2_roofline" in {x["name"] for x in cell.per_layer}
