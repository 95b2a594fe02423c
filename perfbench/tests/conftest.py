"""Fixtures of the benchmark's own tests:

    python -m pytest -q perfbench/tests            # CPU
    python -m pytest -q perfbench/tests -m cuda    # on a card

``mini_root`` is a checkout-shaped directory whose BENCHMARK.json holds
one small cell per driver (the tiny acoustic model with a 16-channel
generator, a few short texts), with the real
metric readers and lexicon linked in, so that a whole run fits on a CPU.
Tests that need a card carry the ``cuda`` marker and decide inside the
test, through the ``card`` fixture, whether one is there."""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from perfbench.harness import load_manifest  # noqa: E402

MINI_CELLS = {
    "mini-narration": ("narration-batch", "es-tiny-ljv2",
                       "tiny-narration-batch",
                       {"batch": 3, "phonemes": [20, 40], "warm_calls": 1,
                        "traced_calls": 1, "named_calls": 1, "sample": 2}),
    "mini-serve": ("serve-short", "es-tiny-ljv2", "tiny-serve-short",
                   {"clients": 3, "phonemes": [50, 90],
                    "server_args": ["--precompile-buckets", "32",
                                    "--max-batch", "4"],
                    "warm_s": 2.0, "traced_s": 1.0, "named_s": 0.5,
                    "sample": 3}),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh)


def make_mini_root(root: str) -> str:
    real = load_manifest(REPO)
    pb = os.path.join(REPO, "perfbench")
    os.symlink(os.path.join(REPO, "lexicon"), os.path.join(root, "lexicon"))
    os.makedirs(os.path.join(root, "perfbench"))
    os.symlink(os.path.join(pb, "metrics"),
               os.path.join(root, "perfbench", "metrics"))
    manifest = dict(real, configs=[], workloads=[],
                    end_to_end=[dict(m) for m in real["end_to_end"]],
                    per_layer=[dict(m) for m in real["per_layer"]])
    rename = {}
    for name, (traffic, config, real_cell, mix_over) in MINI_CELLS.items():
        with open(os.path.join(pb, "configs", config + ".json")) as fh:
            cfg = json.load(fh)
        cfg["hifigan"]["upsample_initial_channel"] = 16
        cfg_name = "mini-" + config
        _dump(os.path.join(root, "perfbench", "configs",
                           cfg_name + ".json"), cfg)
        if cfg_name not in [c["name"] for c in manifest["configs"]]:
            manifest["configs"].append({
                "name": cfg_name, "source": "a test's small copy",
                "file": f"perfbench/configs/{cfg_name}.json",
                "reduced": ["hifigan"], "why": "a test's small copy"})
        with open(os.path.join(pb, "traffic", traffic + ".json")) as fh:
            mix = json.load(fh)
        mix.update(mix_over)
        _dump(os.path.join(root, "perfbench", "traffic", name + ".json"),
              mix)
        with open(os.path.join(pb, "limits", real_cell + ".json")) as fh:
            _dump(os.path.join(root, "perfbench", "limits", name + ".json"),
                  json.load(fh))
        manifest["workloads"].append({"name": name, "config": cfg_name,
                                      "traffic": name, "chips": 1,
                                      "why": "a test's small cell"})
        rename[real_cell] = name
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]
                              if w in rename]
    _dump(os.path.join(root, "BENCHMARK.json"), manifest)
    return root


@pytest.fixture(scope="session")
def mini_root(tmp_path_factory):
    return make_mini_root(str(tmp_path_factory.mktemp("mini_root")))


def run_cell(root, cell, seed, *extra, seconds=2.0, trace=0):
    """One CPU run of a mini cell in this process: (exit code, the parsed
    last line or None, standard error)."""
    import contextlib
    import io

    from perfbench import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace), "--device",
                       "cpu", "--root", root, *extra])
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    last = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, last, err.getvalue()
