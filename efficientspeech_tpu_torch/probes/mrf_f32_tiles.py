"""Probe of the MRF kernel's tile height on the card:

    python -m efficientspeech_tpu_torch.probes.mrf_f32_tiles [--valid 0.9375]
        [--dtype f32|bf16]

For each vocoder stage of a 2,048-frame utterance (the LJ_V2-width
vocoder, random weights from seed 0, folded in float32, or in bf16 with
``--dtype bf16``), it times ``mrf_fused`` with CUDA events at every tile
height the variant's plan (``f32_plan`` or ``bf16_plan``) can fit and at
the plan's own choice, with ``--valid`` of the rows valid (15/16,
the smoke run's kernel phase, by default; a long request's speculative
buffer holds about 0.7), and prints each line with the card's name and
power limit.  A tall tile reads each weight for more rows and recomputes
less halo; how the last wave of tiles fills depends on ``valid``, which
the plan cannot see.  It needs a card and raises without one.
"""

import argparse

import torch

from efficientspeech_tpu_torch.config import HifiGanConfig
from efficientspeech_tpu_torch.device import resolve_device
from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
from efficientspeech_tpu_torch.models.hifigan_folded import (
    fold_hifigan, kernel_op_shapes, prepare_for_kernels)
from efficientspeech_tpu_torch.models.modules import reset_parameters
from efficientspeech_tpu_torch.ops.kernels import mrf_block
from efficientspeech_tpu_torch.utils.timing import card, time_ms

FRAMES = 2048


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--valid", type=float, default=15 / 16,
                        help="fraction of each stage's rows that are valid")
    parser.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                        help="the kernel variant (W_all's dtype)")
    args = parser.parse_args()
    bf16 = args.dtype == "bf16"
    plan = mrf_block.bf16_plan if bf16 else mrf_block.f32_plan
    dtype = torch.bfloat16 if bf16 else torch.float32
    label = "mrf_tiles bf16" if bf16 else "mrf_f32_tiles"
    dev = resolve_device(None)
    name = card()
    cfg = HifiGanConfig()
    gen = HifiGanGenerator(cfg)
    reset_parameters(gen, 0)
    arrays, meta = fold_hifigan(gen.to(dev), dtype)
    _, mrf = prepare_for_kernels(arrays, meta, cfg)
    g = torch.Generator().manual_seed(2)
    for stage, t in kernel_op_shapes(cfg, FRAMES)[1]:
        chains, W_all, b_all, H = mrf[stage]
        widths = mrf_block.chain_widths(chains)
        x = torch.randn(t, 128, generator=g).to(dev)
        valid = torch.tensor([int(t * args.valid)], dtype=torch.int32,
                             device=dev)
        times = []
        for tm in range(16, 257, 16):
            try:
                plan(widths, t, tm)
            except ValueError:
                continue
            ms, _ = time_ms(lambda: mrf_block.mrf_fused(
                x, chains, W_all, b_all, H, valid, 3, tm=tm), 10)
            times.append(f"{tm}: {ms:.4f}")
        print(f"[{label}] stage {stage}, T {t}, valid "
              f"{int(valid)}: plan tm {plan(widths, t).tm} "
              f"| ms by tm {', '.join(times)} | {name}")


if __name__ == "__main__":
    main()
