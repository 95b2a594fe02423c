"""LJSpeech corpus preparation for forced alignment
(reference: preprocessor/ljspeech.py:11-38); a copy of the JAX package's
``data/ljspeech.py``, host numpy only.

metadata.csv → per-utterance 16-bit normalized wav + cleaned ``.lab``
transcript under ``raw_path/<speaker>/``, ready for the (external) Montreal
Forced Aligner to produce TextGrids.
"""

import os

import numpy as np

from efficientspeech_tpu_torch.config import PreprocessConfig
from efficientspeech_tpu_torch.data.preprocessor import load_wav
from efficientspeech_tpu_torch.text import cleaners as cleaners_mod


def prepare_align(config: PreprocessConfig, verbose: bool = True):
    from scipy.io import wavfile

    in_dir = config.corpus_path
    out_dir = config.raw_path
    sampling_rate = config.audio.sampling_rate
    max_wav_value = config.audio.max_wav_value
    cleaner_names = list(config.text_cleaners)
    speaker = "LJSpeech"

    os.makedirs(os.path.join(out_dir, speaker), exist_ok=True)
    n = 0
    with open(os.path.join(in_dir, "metadata.csv"), encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            base_name, text = parts[0], parts[2]
            for name in cleaner_names:
                text = cleaners_mod.CLEANERS[name](text)

            wav_path = os.path.join(in_dir, "wavs", f"{base_name}.wav")
            if not os.path.exists(wav_path):
                continue
            wav = load_wav(wav_path, sampling_rate)
            # peak-normalize to 32767/32768 like the reference
            # (preprocessor/ljspeech.py:28-30)
            wav = wav / max(np.abs(wav).max(), 1e-9) * (max_wav_value - 1)
            wavfile.write(os.path.join(out_dir, speaker, f"{base_name}.wav"),
                          sampling_rate, wav.astype(np.int16))
            with open(os.path.join(out_dir, speaker, f"{base_name}.lab"),
                      "w") as lab:
                lab.write(text)
            n += 1
            if verbose and n % 1000 == 0:
                print(f"  prepared {n} utterances")
    return n
