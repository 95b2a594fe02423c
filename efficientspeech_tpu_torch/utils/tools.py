"""Host-side helpers: buckets and wav IO (copies of the JAX package's
``utils/tools.py`` functions)."""

import os
from typing import List, Optional, Sequence

import numpy as np


def write_wav(wav: np.ndarray, path: str, sampling_rate: int = 22050,
              max_wav_value: float = 32768.0, length: Optional[int] = None):
    """float wav → int16 file, trimmed to ``length`` samples
    (reference: utils/tools.py:19-41)."""
    from scipy.io import wavfile

    wav = np.asarray(wav, dtype=np.float32)
    if length is not None:
        wav = wav[:length]
    wav = np.clip(wav * max_wav_value, -max_wav_value, max_wav_value - 1)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    wavfile.write(path, sampling_rate, wav.astype(np.int16))


def write_batch_wavs(wavs: np.ndarray, lengths: np.ndarray, wav_path: str,
                     filename: str, sampling_rate: int = 22050,
                     max_wav_value: float = 32768.0) -> List[str]:
    """Write prediction-i.wav style batches (reference: utils/tools.py:19-41)."""
    paths = []
    for i, (wav, length) in enumerate(zip(wavs, lengths)):
        p = os.path.join(wav_path, f"{filename}-{i}.wav")
        write_wav(wav, p, sampling_rate, max_wav_value, int(length))
        paths.append(p)
    return paths


def expand(values: np.ndarray, durations: np.ndarray) -> np.ndarray:
    """Repeat phoneme-level values to frame rate (host-side, for plotting;
    reference: utils/tools.py:54-58).  The on-device equivalent is
    ops.length_regulator."""
    return np.repeat(np.asarray(values), np.asarray(durations).astype(int))


def next_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (the largest bucket when none is)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
