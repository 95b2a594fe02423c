"""Acoustic-model training CLI of the PyTorch port (the flags of the JAX
package's ``train.py``):

    python -m efficientspeech_tpu_torch.train --preset tiny \\
        --preprocess-config configs/ljspeech.yaml --batch-size 128 \\
        --hifigan-checkpoint LJ_V2/generator_v2 --wav-path wavs

Training always resumes from the latest checkpoint in
``--checkpoint-dir``, as the JAX trainer's does; ``--resume`` is accepted
and changes nothing.  At each validation the validation audio goes to
``--wav-path`` when ``--hifigan-checkpoint`` names a reference generator
file (its ``config.json`` beside it chooses the vocoder's shape); the
quality metrics go to metrics.jsonl as ``val_*``.

It runs on the CUDA card, and raises without one unless given
``--device cpu``.  ``--precision f32`` computes in float32 throughout:
the decoder's kernels run their float32 variants, and cuDNN's
convolutions and cuBLAS's products are kept out of TF32.
``--device-data`` puts the whole corpus on the card once and gathers each
batch there (``data/device_cache.py``).  ``--device-data-scan-steps`` is
accepted for the JAX package's flags and runs single steps (see
``TrainConfig``).

``--data-parallel N`` trains on N cards (default: all of them): the CLI
spawns one rank a card over NCCL, each takes its rows of every global
batch of ``--batch-size``, and rank 0 writes the logs and the
checkpoints, which resume or serve on one card.  N = 1 runs in this
process with no process group.  With ``--device cpu`` the ranks are CPU
processes over gloo.  N above the number of cards raises.
"""

import argparse
import os
import time

import torch

from efficientspeech_tpu_torch.config import (
    HifiGanConfig, ModelConfig, PreprocessConfig, TrainConfig,
    add_arch_args, arch_overrides)


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", default="tiny",
                        choices=["tiny", "small", "base"])
    parser.add_argument("--preprocess-config",
                        default="configs/ljspeech.yaml")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--weight-decay", type=float, default=1e-5)
    parser.add_argument("--max-epochs", type=int, default=5000)
    parser.add_argument("--warmup-epochs", type=int, default=50)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--data-parallel", type=int, default=None,
                        help="data-parallel ranks, one a card (default: "
                             "all cards; 1 with --device cpu)")
    parser.add_argument("--precision", default="bf16",
                        choices=["bf16", "f32"],
                        help="bf16 compute on float32 masters, or float32 "
                             "throughout (TF32 off)")
    parser.add_argument("--max-phoneme-len", type=int, default=128)
    parser.add_argument("--max-mel-len", type=int, default=1024)
    parser.add_argument("--checkpoint-dir", default="checkpoints",
                        help="training resumes from the latest checkpoint "
                             "here whenever there is one")
    parser.add_argument("--log-dir", default="logs")
    parser.add_argument("--wav-path", default="wavs",
                        help="where the validation audio is written")
    parser.add_argument("--hifigan-checkpoint", default=None,
                        help="reference HiFi-GAN generator file for the "
                             "validation audio; without one only the mel "
                             "and duration metrics are computed")
    parser.add_argument("--resume", action="store_true",
                        help="accepted for the JAX CLI's sake: training "
                             "always resumes from --checkpoint-dir")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card")
    parser.add_argument("--device-data", action="store_true",
                        help="upload the whole preprocessed corpus to the "
                             "card once and gather batches there (a step "
                             "uploads only its batch indices)")
    parser.add_argument("--device-data-bf16-mel", action="store_true",
                        help="store the cached mel targets as bf16 (halves "
                             "their memory and upload)")
    parser.add_argument("--device-data-scan-steps", type=int, default=1,
                        help="the JAX package's optimizer steps per host "
                             "call; accepted for its flags, the port runs "
                             "single steps")
    add_arch_args(parser)
    return parser.parse_args(argv)


def load_vocoder(hifigan_checkpoint):
    """(HifiGanConfig, JAX-layout params or None) of a reference generator
    file, its ``config.json`` beside it choosing the shape; the LJ_V2
    widths and None when there is no such file."""
    if not (hifigan_checkpoint and os.path.isfile(hifigan_checkpoint)):
        return HifiGanConfig(), None
    from efficientspeech_tpu_torch.convert.from_torch import (
        load_hifigan_checkpoint)

    cfg_json = os.path.join(os.path.dirname(hifigan_checkpoint),
                            "config.json")
    cfg = (HifiGanConfig.from_json(cfg_json) if os.path.isfile(cfg_json)
           else HifiGanConfig())
    return cfg, load_hifigan_checkpoint(
        hifigan_checkpoint, num_kernels=len(cfg.resblock_kernel_sizes))


def main(argv=None):
    args = get_args(argv)
    from efficientspeech_tpu_torch.device import resolve_device
    from efficientspeech_tpu_torch.parallel.mesh import launch, make_mesh

    device = resolve_device(args.device)
    n = args.data_parallel
    if device.type == "cuda":
        n = make_mesh(data_parallel=n).axis_size("data")
    elif n is None:
        n = 1
    if n == 1:
        return run(device, args)
    devices = ([torch.device("cuda", i) for i in range(n)]
               if device.type == "cuda" else [device] * n)
    return launch(run, n, devices, args=(args, n))[0]


def run(device, args, data_parallel: int = 1):
    """Train on ``device`` as one rank of ``data_parallel`` (the body of
    each spawned rank); returns the final step."""
    from efficientspeech_tpu_torch.device import set_full_f32
    from efficientspeech_tpu_torch.training.loop import Trainer

    if args.precision == "f32":
        set_full_f32()
    preprocess_cfg = PreprocessConfig.from_yaml(args.preprocess_config)
    stats = preprocess_cfg.load_stats()
    model_cfg = ModelConfig.preset(
        args.preset, pitch_stats=tuple(stats["pitch"][:2]),
        energy_stats=tuple(stats["energy"][:2]),
        max_phoneme_len=args.max_phoneme_len, max_mel_len=args.max_mel_len,
        **arch_overrides(args))
    train_cfg = TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay,
        batch_size=args.batch_size, max_epochs=args.max_epochs,
        warmup_epochs=args.warmup_epochs, precision=args.precision,
        seed=args.seed, checkpoint_dir=args.checkpoint_dir,
        log_dir=args.log_dir, wav_path=args.wav_path,
        device_data=args.device_data,
        device_cache_bf16_mel=args.device_data_bf16_mel,
        device_data_scan_steps=args.device_data_scan_steps,
        num_data_axis=data_parallel)
    hifigan_cfg, hifigan_params = load_vocoder(args.hifigan_checkpoint)
    trainer = Trainer(model_cfg, train_cfg, preprocess_cfg,
                      hifigan_cfg=hifigan_cfg, hifigan_params=hifigan_params,
                      dtype=torch.bfloat16 if args.precision == "bf16"
                      else torch.float32, device=device)
    trainer.print_rank0(f"training on {device} x {data_parallel}: "
                        f"{trainer.steps_per_epoch} steps per epoch")
    start = time.time()
    final_step = trainer.fit(max_epochs=args.max_epochs,
                             max_steps=args.max_steps)
    elapsed = time.time() - start
    trainer.print_rank0(f"Training done at step {final_step}: "
                        f"{elapsed:.2f}s ({elapsed / 3600:.2f}h)")
    return final_step


if __name__ == "__main__":
    main()
