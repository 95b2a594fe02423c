"""Checkpoint conversion and export CLI of the port (the flags of the root
``convert.py``, plus ``--device``).

    # reference torch .ckpt → the port's native parameter file
    python -m efficientspeech_tpu_torch.convert \\
        --checkpoint tiny_eng_266k.ckpt --preset tiny --output tiny.pt

    # → a torch.export program (.pt2) of phoneme IDs → wav, at --precision
    python -m efficientspeech_tpu_torch.convert \\
        --checkpoint tiny_eng_266k.ckpt --export tiny_eng.pt2 --insize 128

    # → .onnx / traced TorchScript, float32 (the reference's formats)
    python -m efficientspeech_tpu_torch.convert \\
        --checkpoint tiny_eng_266k.ckpt --onnx tiny_eng.onnx \\
        --torchscript tiny_eng.ts --insize 128

``--checkpoint`` is a reference ``.ckpt``, a checkpoint of the port's
trainer or a native parameter file.  The vocoder comes from the
checkpoint where it holds one, else from ``--hifigan-checkpoint`` when
that file exists, else it is a random init.  Every program is traced on
the device (the card unless ``--device cpu``; without a card it raises)
and fixed at ``--insize`` phonemes and 16 mel frames a phoneme.
"""

import argparse
import os

import torch

from efficientspeech_tpu_torch.config import add_arch_args, arch_overrides


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", default="tiny",
                        choices=["tiny", "small", "base"])
    parser.add_argument("--checkpoint", required=True,
                        help="reference .ckpt, a step_*.pt of the port's "
                             "trainer (or its directory), or a native "
                             "parameter file")
    parser.add_argument("--hifigan-checkpoint", default=None,
                        help="reference HiFi-GAN generator file; random "
                             "vocoder weights when it is not a file")
    parser.add_argument("--output", default=None,
                        help="write the port's native parameter file here")
    parser.add_argument("--export", default=None,
                        help="write a torch.export program (.pt2) here, "
                             "in --precision")
    parser.add_argument("--onnx", default=None,
                        help="write a float32 .onnx here")
    parser.add_argument("--onnx-opset", type=int, default=17)
    parser.add_argument("--torchscript", default=None,
                        help="write a float32 traced TorchScript module "
                             "here")
    parser.add_argument("--insize", type=int, default=128,
                        help="fixed phoneme length of the exported "
                             "programs (reference --onnx-insize)")
    parser.add_argument("--precision", default="bf16", choices=["bf16", "f32"])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    add_arch_args(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from efficientspeech_tpu_torch.device import resolve_device, set_full_f32
    from efficientspeech_tpu_torch.infer import build_model, save_model_params

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    if dtype == torch.float32:
        set_full_f32()
    hifigan_ckpt = args.hifigan_checkpoint
    model = build_model(
        preset=args.preset, checkpoint=args.checkpoint,
        hifigan_checkpoint=(hifigan_ckpt if hifigan_ckpt
                            and os.path.isfile(hifigan_ckpt) else None),
        model_overrides=arch_overrides(args)).to(device).eval()
    cfg, hifigan_cfg = model.cfg, model.hifigan_cfg
    written = {}

    if args.output:
        save_model_params(args.output, model)
        print(f"wrote native params to {args.output}")
        written["output"] = args.output

    if args.export:
        from efficientspeech_tpu_torch.convert.export import (
            export_text_to_wav, save_exported)

        program = export_text_to_wav(cfg, hifigan_cfg, model,
                                     insize=args.insize, dtype=dtype)
        size = save_exported(args.export, program)
        print(f"wrote torch.export program ({size} bytes, "
              f"{args.precision}) to {args.export}")
        written["export"] = args.export

    if args.onnx:
        from efficientspeech_tpu_torch.convert.onnx_export import export_onnx

        size = export_onnx(cfg, hifigan_cfg, model, args.onnx,
                           insize=args.insize, opset=args.onnx_opset)
        print(f"wrote ONNX model ({size} bytes) to {args.onnx}")
        written["onnx"] = args.onnx

    if args.torchscript:
        from efficientspeech_tpu_torch.convert.onnx_export import (
            export_torchscript)

        size = export_torchscript(cfg, hifigan_cfg, model, args.torchscript,
                                  insize=args.insize)
        print(f"wrote TorchScript module ({size} bytes) to "
              f"{args.torchscript}")
        written["torchscript"] = args.torchscript
    return written


if __name__ == "__main__":
    main()
