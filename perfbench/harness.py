"""The benchmark's core: the manifest, one cell's files found by name,
the run's clock, the per-layer metric readers, and the result line.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a
configuration (``perfbench/configs/<name>.json``) and a traffic mix
(``perfbench/traffic/<name>.json``, whose ``driver`` names the module of
``perfbench/drivers`` that runs it); each per-layer metric is read by
``perfbench/metrics/<name>.py``; each cell's limits of ``correct`` are in
``perfbench/limits/<cell>.json``.  Adding any of them is adding files.
"""

import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the measured program is the PyTorch port; these top-level modules (the
# JAX package and JAX itself) must never be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "efficientspeech_tpu")


def load_manifest(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One workload of the manifest with its configuration, traffic mix,
    limits and per-layer metrics resolved by name."""

    def __init__(self, manifest: Dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.root = root
        self.spec = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.spec["config"]]
        self.config = _json(os.path.join(root, self.config_entry["file"]))
        self.mix = _json(os.path.join(root, "perfbench", "traffic",
                                      self.spec["traffic"] + ".json"))
        self.limits = _json(os.path.join(root, "perfbench", "limits",
                                         name + ".json"))
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]

    def driver(self):
        return importlib.import_module(
            "perfbench.drivers." + self.mix["driver"])


def metric_reader(name: str, root: str = ROOT):
    """``read(m) -> number | None`` of ``perfbench/metrics/<name>.py``."""
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Clock:
    """The run's host clock: set-up from the process's start to the
    window's start."""

    def __init__(self, t0: Optional[float] = None):
        self.t0 = time.perf_counter() if t0 is None else t0
        self.setup_s = None
        self.phases = {}

    def mark(self, phase: str):
        """Seconds since the process started, at the end of a set-up
        phase (printed on standard error with the result)."""
        self.phases[phase] = round(time.perf_counter() - self.t0, 3)

    def setup_done(self, at: Optional[float] = None):
        """Set-up ends now, or at ``at`` on the ``perf_counter`` clock."""
        end = time.perf_counter() if at is None else at
        self.setup_s = end - self.t0
        self.phases["window"] = round(self.setup_s, 3)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict], device: Dict,
                checks: Dict[str, Dict], breakdown: Optional[Dict] = None,
                control: Optional[Dict] = None) -> str:
    """The result line; ``control`` (a control run's own judgement) and
    then ``checks`` (each compared number beside its limit) come last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control is not None:
        out["control"] = control
    out["checks"] = checks
    return json.dumps(out)


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every number at or under its limit; a number
    without a reading (None, NaN) fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and v == v and v <= limit
        ok &= good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
