"""Corpus preparation for forced alignment, in the PyTorch port
(counterpart of the root ``prepare_align.py``; host work only):

    python -m efficientspeech_tpu_torch.prepare_align configs/ljspeech.yaml
"""

import argparse

from efficientspeech_tpu_torch.config import PreprocessConfig


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("config", type=str, help="path to preprocess.yaml")
    args = parser.parse_args(argv)
    from efficientspeech_tpu_torch.data import ljspeech

    config = PreprocessConfig.from_yaml(args.config)
    if config.dataset == "LJSpeech":
        return ljspeech.prepare_align(config)
    raise ValueError(f"unknown dataset {config.dataset!r}")


if __name__ == "__main__":
    main()
