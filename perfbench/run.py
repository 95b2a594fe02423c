"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell
asks for.  Set-up (loading, warming every shape of the cell's traffic,
kernels built or loaded from ``build/``) is timed as ``setup_s``; then the
window measures for ``--seconds``.  With ``--trace 1`` a profiled stretch
inside the window gives the per-layer metrics.  After the window the
plain reference judges a sample of what the timed path produced; each
compared number is printed beside its limit as the last lines of
standard error, and the last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` (traced runs) and ``checks``.

``--control fp8`` also judges, by the same limits, the reference computed
with fp8 operands in the program's place: the line then carries
``control`` (its ``correct``, which has to come out false, and its
``checks``) before ``checks``.  ``--fault <name>`` plants a fault in the
timed path (see the cell's driver), so that ``correct`` reads the broken
program.  Both are for setting limits and for the tests, not for
measuring.  ``--device cpu`` runs without a card, for the tests.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    p.add_argument("--control", default=None, choices=("fp8",))
    p.add_argument("--fault", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def cache_env(root: str):
    """Caches of compilers at fixed paths inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build",
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def main(argv=None, t0=None) -> int:
    args = get_args(argv)
    cache_env(args.root)
    from perfbench import harness

    cell = harness.Cell(harness.load_manifest(args.root), args.workload,
                        root=args.root)
    import torch

    chips = int(cell.spec["chips"])
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < chips):
        print(f"{cell.name} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    clock = harness.Clock(T0 if t0 is None else t0)
    clock.mark("imports")
    out = cell.driver().run(cell, args, clock, torch.device(args.device))

    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"], args.root)(out["layer"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": clock.setup_s, "unit": "s"}}
        for m in cell.end_to_end:
            if m["name"] != "setup_s":
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    gpu = args.device == "cuda"
    device = {"platform": "gpu" if gpu else "cpu",
              "kind": torch.cuda.get_device_name(0) if gpu else "cpu",
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    breakdown = None
    if args.trace and out.get("trace"):
        t = out["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        breakdown = {"device_ops": t["device_ops"],
                     "idle_gaps": t["idle_gaps"]}
        print(json.dumps({"traced": {k: t[k] for k in (
            "window_s", "busy_s", "device_op_count")}}), file=sys.stderr)
    correct, checks = harness.judge(out["numbers"], cell.limits)
    control = None
    if args.control:
        ok, ctrl_checks = harness.judge(out["control"], cell.limits)
        control = {"precision": args.control, "correct": ok,
                   "checks": ctrl_checks}
    print(json.dumps({"setup_phases": clock.phases}), file=sys.stderr)
    if control:
        for name, c in control["checks"].items():
            print(f"control check {name} {c['value']} limit {c['limit']}",
                  file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the JAX side may not run here",
              file=sys.stderr)
        return 4
    print(harness.result_line(correct, out["attempted"], out["failed"],
                              metrics, device, checks, breakdown,
                              control),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
