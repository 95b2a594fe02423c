"""What a run loads: no JAX, no JAX package (top-level module names
compared whole), and the reference loads nothing of the program."""

import os
import subprocess
import sys

from perfbench.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "efficientspeech_tpu"}


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_program():
    mods = loaded_after(
        "import perfbench.reference.model, perfbench.reference.frontend, "
        "perfbench.reference.precision")
    assert not mods & (FORBIDDEN | {"efficientspeech_tpu_torch"})


def test_harness_and_drivers_load_no_jax():
    mods = loaded_after(
        "import perfbench.run, perfbench.harness\n"
        "import perfbench.drivers.narration_batch, perfbench.drivers.serve\n"
        "from perfbench.harness import load_manifest, Cell, metric_reader\n"
        "m = load_manifest()\n"
        "for w in m['workloads']: Cell(m, w['name']).driver()\n"
        "for x in m['per_layer']: metric_reader(x['name'])\n"
        "from efficientspeech_tpu_torch import infer, serve")
    assert "efficientspeech_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_a_whole_run_loads_no_jax(mini_root):
    mods = loaded_after(
        "from perfbench import run\n"
        f"assert run.main(['--workload', 'mini-narration', '--seed', '5',"
        f" '--seconds', '1', '--trace', '0', '--device', 'cpu', '--root',"
        f" {mini_root!r}]) == 0")
    assert not mods & FORBIDDEN


def test_client_loads_no_torch():
    mods = loaded_after("import perfbench.drivers.serve_client")
    assert "torch" not in mods


def test_without_the_program_a_run_prints_no_result(tmp_path):
    import shutil

    shutil.copytree(os.path.join(REPO, "perfbench"),
                    str(tmp_path / "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), str(tmp_path))
    for extra in ([], ["--device", "cpu"]):
        out = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload",
             "tiny-narration-batch", "--seed", "1", "--seconds", "1",
             "--trace", "0", *extra], cwd=str(tmp_path),
            capture_output=True, text=True, timeout=300,
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        assert out.returncode != 0
        assert not out.stdout.strip()
