"""Slaney-style mel filterbank (librosa-compatible); a copy of the JAX
package's ``audio/mel.py``.

Self-contained reimplementation of ``librosa.filters.mel`` with its default
``htk=False, norm='slaney'`` parameters, which is what the reference uses
for feature extraction (reference: audio/stft.py:149-151).
"""

from typing import Optional

import numpy as np


def _hz_to_mel_slaney(freqs: np.ndarray) -> np.ndarray:
    freqs = np.asanyarray(freqs, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freqs - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freqs >= min_log_hz
    mels = np.where(log_region,
                    min_log_mel + np.log(np.maximum(freqs, 1e-10) / min_log_hz)
                    / logstep,
                    mels)
    return mels


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(log_region,
                     min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                     freqs)
    return freqs


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 80,
                   fmin: float = 0.0, fmax: Optional[float] = None
                   ) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular filters with slaney normalization."""
    if fmax is None:
        fmax = float(sr) / 2
    fftfreqs = np.linspace(0, float(sr) / 2, 1 + n_fft // 2, endpoint=True)
    mel_min = _hz_to_mel_slaney(np.array([fmin]))[0]
    mel_max = _hz_to_mel_slaney(np.array([fmax]))[0]
    mel_f = _mel_to_hz_slaney(np.linspace(mel_min, mel_max, n_mels + 2))

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))

    # slaney normalization: each filter integrates to ~constant energy
    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)
