"""Where K4's kernels spend their time, on the card:

    python -m efficientspeech_tpu_torch.probes.k4_bwd_phases [--dtype bf16]
    python -m efficientspeech_tpu_torch.probes.k4_bwd_phases --pass fwd \
        [--dtype bf16]

Builds ``csrc/decoder_block.cu`` once more with ``-DDECODER_BLOCK_STAMPS``
(into ``build/kernels/``), which makes thread 0 of every block of each
kernel add the ``%globaltimer`` time between the kernel's phase stamps to
a device array, and runs the backward or the forward (float32 or bf16)
through that build at the training shape (128, 1024, C), C = 128 and
256, with chip_smoke.py's inputs.  It prints, per launch, each phase's
time summed over a block's tiles and averaged over the blocks, its share,
and the launch's CUDA-event time with and without the stamps, with the
card's name and power limit.  A phase ends at the barrier after it, so it
includes the wait for the block's slowest warp (in bf16 at C = 256, for
the other block of its cluster too; a forward's row pass is thread 0's
warp's, the wait for the others falls in the next tile's first phase).
It needs a card and raises without one.
"""

import argparse
import ctypes
import subprocess

import torch

from efficientspeech_tpu_torch.device import resolve_device
from efficientspeech_tpu_torch.ops.kernels import build
from efficientspeech_tpu_torch.ops.kernels import decoder_block as k4
from efficientspeech_tpu_torch.utils.timing import card, time_ms

# the stamps' phases, in the kernel's order, by pass and dtype (csrc:
# DB_STAMP)
PHASES = {
    "fwd f32": ("wait for x's rows and the slowest warp",
                "depthwise + split u", "v = u W (wgmma)",
                "v's rows over the split buffer", "row pass: t, LayerNorm, y"),
    "fwd bf16": ("wait for x's rows and the slowest warp", "depthwise u",
                 "v = u W (wgmma)", "t and the row sums",
                 "LayerNorm and y"),
    "f32": ("load x", "depthwise + split u", "v = u W (wgmma)",
            "row pass: t, LayerNorm, dv", "weight gradient (mma.sync)",
            "split dv", "du = dv W^T (wgmma)", "load x again",
            "dx and taps", "final sums"),
    "bf16": ("masked x rows", "depthwise u", "u to the cluster",
             "v = u W (wgmma)", "row pass: t, row sums",
             "dv to the cluster, column sums", "wait for x and dy",
             "dW and du (wgmma), next loads issued", "du, dx and taps",
             "final sums"),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
LAUNCHES = 10
N_STAMPS = 10  # the stamps' device array (csrc: N_STAMPS)


def _stamped_lib() -> ctypes.CDLL:
    """decoder_block.cu built with the stamps, with the wrapper's
    signatures and the stamps' reader."""
    path = build._lib_path("decoder_block").with_name(
        build._lib_path("decoder_block").stem + "_stamps.so")
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-DDECODER_BLOCK_STAMPS",
             "-o", str(path), str(build.CSRC / "decoder_block.cu")],
            capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(path))
    sigs = dict(k4._SIGNATURES,
                kernel_error_string=([ctypes.c_int], ctypes.c_char_p),
                decoder_block_stamps=([ctypes.c_void_p], ctypes.c_int))
    for fn, (argtypes, restype) in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def _inputs(c: int, dt: torch.dtype, dev):
    """chip_smoke.phase_k4's inputs: (128, 1024, c), padded tails."""
    b, m, k = 128, 1024, 5
    gen = torch.Generator(device="cpu").manual_seed(4)
    f = lambda *shape, sd=1.0: (torch.randn(*shape, generator=gen) * sd
                                ).to(dev)
    x = f(b, m, c).to(dt)
    lengths = torch.randint(2 * m // 3, m + 1, (b,), generator=gen)
    keep = (torch.arange(m)[None, :] < lengths[:, None]).float().to(dev)
    # the depthwise and pointwise weights and biases, the LayerNorm scale
    # and bias (the backward skips the last)
    weights = [f(c, 1, k, sd=0.4), f(c, sd=0.1),
               f(c, c, 1, sd=0.09 * (128 / c) ** 0.5), f(c, sd=0.1),
               1 + f(c, sd=0.2), f(c, sd=0.1)]
    return x, keep, weights, f(b, m, c).to(dt)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    parser.add_argument("--pass", dest="direction", choices=("bwd", "fwd"),
                        default="bwd")
    args = parser.parse_args()
    fwd = args.direction == "fwd"
    dt = DTYPES[args.dtype]
    phases = PHASES[f"fwd {args.dtype}" if fwd else args.dtype]
    f32 = int(dt == torch.float32)
    dev = resolve_device(None)
    name = card()
    plain_lib, stamped, lib_fn = k4._lib(), _stamped_lib(), k4._lib
    sums = (ctypes.c_ulonglong * N_STAMPS)()
    for c in k4.WIDTHS:
        x, keep, weights, dy = _inputs(c, dt, dev)
        grid = k4._grid(plain_lib, x.shape[0], x.shape[1], c, f32, not fwd,
                        dev)
        if fwd:
            run = lambda: k4.decoder_block_fwd(x, keep, *weights)
        else:
            run = lambda: k4.decoder_block_bwd(x, keep, *weights[:5], dy)
        ms_plain, _ = time_ms(run, 20)
        k4._lib = lambda: stamped
        try:
            ms_stamped, _ = time_ms(run, 20)
            build.check(stamped, stamped.decoder_block_stamps(sums), "stamps")
            for _ in range(LAUNCHES):
                run()
            torch.cuda.synchronize(dev)
            build.check(stamped, stamped.decoder_block_stamps(sums), "stamps")
        finally:
            k4._lib = lib_fn
        per = [v / 1e6 / LAUNCHES / grid for v in sums[:len(phases)]]
        total = sum(per)
        tag = f"k4 {args.dtype} {args.direction} C={c}"
        print(f"[{tag}] kernel_ms {ms_plain:.4f} (stamped {ms_stamped:.4f}), "
              f"{grid} blocks, phases sum {total:.4f} ms a block | {name}")
        for phase, ms in zip(phases, per):
            print(f"[{tag}]   {phase}: {ms:.4f} ms "
                  f"({100 * ms / total:.1f}%) | {name}")


if __name__ == "__main__":
    main()
