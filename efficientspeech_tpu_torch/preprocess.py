"""Dataset preprocessing CLI of the PyTorch port (counterpart of the root
``preprocess.py``):

    python -m efficientspeech_tpu_torch.preprocess configs/ljspeech.yaml \\
        [--num-workers N] [--device D]

Reads the raw corpus and its TextGrids, writes mel/, pitch/, energy/,
duration/, train.txt, val.txt, speakers.json and stats.json under the
config's ``preprocessed_path``.  The mel and energy are computed on the
CUDA card, which raises without one unless given ``--device cpu``; the
wav, the TextGrid and the pitch stay on the host (``--num-workers`` > 1
spreads them over a process pool).
"""

import argparse
import time

from efficientspeech_tpu_torch.config import PreprocessConfig


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("config", type=str, help="path to preprocess.yaml")
    parser.add_argument("--num-workers", type=int, default=0,
                        help="fan the host part of each utterance over a "
                             "process pool (the reference is "
                             "single-process)")
    parser.add_argument("--device", default=None,
                        help="torch device for the mel and energy "
                             "(default: the card)")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from efficientspeech_tpu_torch.data.preprocessor import Preprocessor

    config = PreprocessConfig.from_yaml(args.config)
    preprocessor = Preprocessor(config, device=args.device)
    t0 = time.perf_counter()
    out = preprocessor.build_from_path(num_workers=args.num_workers)
    print(f"preprocessed {len(out)} utterances on "
          f"{preprocessor.stft.device} in {time.perf_counter() - t0:.1f} s")
    return out


if __name__ == "__main__":
    main()
