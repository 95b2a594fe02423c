"""Probe of the card's int8 tensor cores for the folded vocoder (the
counterpart of the JAX package's ``benchmarks/int8_pallas_probe.py`` and
``benchmarks/int8_matmul_probe.py``):

    python -m efficientspeech_tpu_torch.probes.int8_window
    python -m efficientspeech_tpu_torch.probes.int8_window --device cpu

On the card, at the d128 serving shape (T 49,152 rows, a 5-tap window,
128 → 128, tiles of tm = 512 rows), it prints the CUDA-event time per
call, after a warm-up, of
  - kernel K1's production route (``folded_matmul``, w = 2, pre-lrelu,
    float32 input),
  - kernel K5 with bf16 input and tile quantisation,
  - kernel K5 with int8 input,
  - ``torch._int_mm`` against bf16 ``torch.matmul`` at (49152, 640, 128)
    and (8192, 2048, 2048),
each line with the card's name and power limit.  With ``--device cpu``
it runs K5's plain version at a small shape and prints the output's shape
and largest magnitude: no times, as a CPU time is not the card's.
Without a card and without ``--device cpu`` it raises.
"""

import argparse
from typing import Dict

import numpy as np
import torch

from efficientspeech_tpu_torch.device import resolve_device
from efficientspeech_tpu_torch.ops.kernels import folded_matmul as k1
from efficientspeech_tpu_torch.ops.kernels import int8_window as k5
from efficientspeech_tpu_torch.utils.timing import card, time_ms

# (T, d_in, d_out, n_win, tm): the d128 resblock serving shape, 3,072
# frames × 16 rows
SHAPE = (49152, 128, 128, 5, 512)
CPU_SHAPE = (256, 128, 128, 5, 64)
# (M, K, N): the window's product at that shape, and a large square one
MATMUL_SHAPES = ((49152, 640, 128), (8192, 2048, 2048))


def probe_inputs(t: int, d_in: int, d_out: int, n_win: int, tm: int,
                 device, seed: int = 0):
    """The JAX probe's inputs: ``default_rng(seed)``, first x (bf16, and
    int8 as x · 40 clipped and truncated), then W (int8)."""
    rng = np.random.default_rng(seed)
    _, rows = k5.layout(t, tm, n_win)
    xs = rng.normal(size=(rows, d_in))
    w = rng.integers(-127, 127, size=(n_win * d_in, d_out)).astype(np.int8)
    x_bf16 = torch.from_numpy(xs.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    x_int8 = torch.from_numpy(np.clip(xs * 40, -127, 127).astype(np.int8))
    return x_bf16, x_int8.to(device), torch.from_numpy(w).to(device)


def run(device=None, iters: int = 50) -> Dict[str, float]:
    """Time the routes (on the card) or run the plain version (on the
    CPU); returns what it printed, by name."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        t, d_in, d_out, n_win, tm = CPU_SHAPE
        xb, xi, w = probe_inputs(t, d_in, d_out, n_win, tm, dev)
        out = {}
        for name, x in (("k5_bf16", xb), ("k5_int8", xi)):
            y = k5.int8_window_matmul(x, w, n_win, tm)
            out[name] = float(y.abs().max())
            print(f"[probe] {name} plain on the cpu: out {tuple(y.shape)}, "
                  f"max |out| {out[name]:.6g}")
        return out

    name = card()
    t, d_in, d_out, n_win, tm = SHAPE
    xb, xi, w = probe_inputs(t, d_in, d_out, n_win, tm, dev)
    rng = np.random.default_rng(1)
    x32 = torch.from_numpy(rng.normal(size=(t, d_in)).astype(np.float32)
                           ).to(dev)
    w16 = torch.from_numpy((rng.normal(size=(n_win * d_in, d_out)) * 0.1
                            ).astype(np.float32)).to(dev, torch.bfloat16)
    b32 = torch.from_numpy((rng.normal(size=(d_out,)) * 0.1
                            ).astype(np.float32)).to(dev)
    valid = torch.tensor([t], dtype=torch.int32, device=dev)
    at = f" at T {t} x {d_in} -> {d_out}, {n_win} taps, tm {tm}"
    routes = {
        "k1_folded_matmul": (lambda: k1.folded_matmul(
            x32, w16, b32, n_win // 2, valid, pre_lrelu=True), at),
        "k5_bf16": (lambda: k5.int8_window_matmul(xb, w, n_win, tm), at),
        "k5_int8": (lambda: k5.int8_window_matmul(xi, w, n_win, tm), at),
    }
    gen = torch.Generator(device="cpu").manual_seed(2)
    for m, k, n in MATMUL_SHAPES:
        a8 = torch.randint(-127, 127, (m, k), generator=gen,
                           dtype=torch.int8).to(dev)
        # B column-major: the layout the int8 library product takes
        b8 = torch.randint(-127, 127, (n, k), generator=gen,
                           dtype=torch.int8).to(dev).t()
        a16 = torch.randn(m, k, generator=gen).to(dev, torch.bfloat16)
        b16 = torch.randn(k, n, generator=gen).to(dev, torch.bfloat16)
        routes[f"int_mm_{m}x{k}x{n}"] = (
            lambda a8=a8, b8=b8: torch._int_mm(a8, b8), "")
        routes[f"bf16_matmul_{m}x{k}x{n}"] = (
            lambda a16=a16, b16=b16: torch.matmul(a16, b16), "")
    out = {}
    for key, (fn, where) in routes.items():
        out[key], _ = time_ms(fn, iters)
        print(f"[probe] {key}{where}: {out[key]:.4f} ms per call | {name}")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
