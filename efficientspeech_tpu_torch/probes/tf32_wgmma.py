"""Probe of the float32 kernels' 3xTF32 k loop on the card:

    python -m efficientspeech_tpu_torch.probes.tf32_wgmma

Runs ``tf32x3::k_loop`` (``csrc/tf32x3.cuh``), the loop of the float32
variants of folded_matmul (K1) and mrf_fused (K2), on its own
(``csrc/tf32_probe.cu``): one block of two warpgroups an SM, each k-step
three ``wgmma.m64nNk8`` TF32 products, with A, the weights, loaded from
L2 each step as the kernels load it (two or four steps ahead: K1's and
K2's depths) or held in registers.  For N = 16, 64 and 128 rows it
prints the rate of the products against the H100's dense TF32 peak
(494.7 TFLOP/s), from CUDA-event times, with the card's name and power
limit: what the A loads cost at each tile height.  It needs a card and
raises without one.
"""

import ctypes

import torch

from efficientspeech_tpu_torch.device import resolve_device
from efficientspeech_tpu_torch.ops.kernels import build
from efficientspeech_tpu_torch.utils.timing import card

PEAK_TF32_FLOPS = 494.7e12
ROWS = (16, 64, 128)
NSTEPS = 4096

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"tf32_probe_launch": ([_I] * 3 + [_P] * 2 + [_I] * 2 + [_P],
                                     _I)}


def _lib():
    return build.load("tf32_probe", _SIGNATURES)


def rate(n: int, from_l2: bool, ahead: int, W: torch.Tensor,
         reps: int = 5) -> float:
    """TFLOP/s of the loop's products (3 x 2 x 64 x n x 8 x 2 FLOP a step
    and warpgroup) for one configuration, after one warm-up launch."""
    lib = _lib()
    dev = W.device
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(blocks * 256, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        build.check(lib, lib.tf32_probe_launch(
            n, int(from_l2), ahead, W.data_ptr(), out.data_ptr(), blocks,
            NSTEPS, stream), "tf32_probe")

    launch()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        launch()
    t1.record()
    torch.cuda.synchronize(dev)
    ms = t0.elapsed_time(t1) / reps
    flop = blocks * 2 * NSTEPS * 3 * 64 * n * 8 * 2
    return flop / ms / 1e9


def main():
    dev = resolve_device(None)
    name = card()
    W = torch.randn(1024 * 8 * 128 + 1024, device=dev)
    for n in ROWS:
        for from_l2, ahead in ((False, 2), (True, 2), (True, 4)):
            r = rate(n, from_l2, ahead, W)
            src = f"from L2, {ahead} steps ahead" if from_l2 else \
                "in registers"
            print(f"[tf32_wgmma] N {n}, A {src}: {r:.1f} TFLOP/s, "
                  f"{100 * r * 1e12 / PEAK_TF32_FLOPS:.1f}% of the TF32 "
                  f"peak | {name}")


if __name__ == "__main__":
    main()
