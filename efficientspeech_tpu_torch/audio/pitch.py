"""Fundamental-frequency (F0) extraction: a copy of the JAX package's
``audio/pitch.py``, host numpy, so its values are bit-equal by
construction.  Backend order:

- ``pyworld`` verbatim when installed (bit-exact reference parity),
- the native numpy DIO + StoneMask port (``audio/dio.py``) otherwise,
  the default wherever pyworld is missing,
- YIN (de Cheveigné & Kawahara 2002) only as an explicit
  ``backend="yin"``: C++ (``csrc/yin_pitch.cpp``, built with g++ into
  ``build/host/`` at first use and loaded by ctypes; a missing compiler or
  a failed build raises, there is no quiet numpy fallback), or
  ``yin_pitch_numpy`` called by name.

stats.json records the extractor that built a dataset (see
data/preprocessor.py) so mixed-extractor datasets are detectable.
"""

import ctypes

import numpy as np

from efficientspeech_tpu_torch.ops.kernels import build

try:  # exact reference parity when available
    import pyworld as _pw
except ImportError:
    _pw = None

_F32P = ctypes.POINTER(ctypes.c_float)
_YIN_SIGNATURES = {"yin_pitch": ([
    _F32P, ctypes.c_int,                               # wav, n
    ctypes.c_int, ctypes.c_int,                        # sr, hop
    ctypes.c_float, ctypes.c_float, ctypes.c_float,    # fmin, fmax, thresh
    _F32P, ctypes.c_int,                               # out, n_frames
], None)}


def yin_pitch_numpy(wav: np.ndarray, sr: int, hop: int,
                    fmin: float = 71.0, fmax: float = 800.0,
                    threshold: float = 0.15,
                    frame_length: int = 1024) -> np.ndarray:
    """Vectorized YIN; returns f0 per frame (0 = unvoiced),
    n_frames = len(wav)//hop + 1 (matches pyworld.dio's frame count)."""
    wav = np.asarray(wav, dtype=np.float64)
    n = len(wav)
    n_frames = n // hop + 1
    tau_min = max(2, int(sr / fmax))
    tau_max = int(sr / fmin) + 1
    w = frame_length
    span = w + tau_max

    padded = np.pad(wav, (0, span))
    starts = np.arange(n_frames) * hop
    frames = padded[starts[:, None] + np.arange(span)[None, :]]  # (F, span)

    # difference function via cumulative sums + FFT cross-correlation:
    # d(tau) = sum_{j<w} (x[j] - x[j+tau])^2
    #        = E0 + E_tau - 2 * corr(tau)
    fft_n = 1
    while fft_n < span + w:
        fft_n *= 2
    X = np.fft.rfft(frames, fft_n)
    Xw = np.fft.rfft(frames[:, :w][:, ::-1], fft_n)
    corr_full = np.fft.irfft(X * Xw, fft_n)        # corr(tau) at index w-1+tau
    corr = corr_full[:, w - 1: w - 1 + tau_max + 1]

    sq = frames ** 2
    csum = np.cumsum(sq, axis=1)
    e0 = csum[:, w - 1]                             # sum_{j<w} x_j^2
    # e_tau = sum_{j<w} x_{j+tau}^2 = csum[tau+w-1] - csum[tau-1]
    idx = np.arange(tau_max + 1)
    e_tau = csum[:, idx + w - 1] - np.concatenate(
        [np.zeros((n_frames, 1)), csum[:, idx[1:] - 1]], axis=1)
    d = e0[:, None] + e_tau - 2 * corr              # (F, tau_max+1)
    d = np.maximum(d, 0.0)

    # cumulative-mean-normalized difference
    cum = np.cumsum(d[:, 1:], axis=1)
    cmnd = np.ones_like(d)
    cmnd[:, 1:] = d[:, 1:] * np.arange(1, tau_max + 1) / np.maximum(cum, 1e-12)

    f0 = np.zeros(n_frames)
    region = cmnd[:, tau_min: tau_max + 1]
    below = region < threshold
    energy = e0 / w
    for i in range(n_frames):
        if energy[i] < 1e-6:  # silence
            continue
        hits = np.where(below[i])[0]
        if len(hits) == 0:
            continue
        tau = hits[0] + tau_min
        # walk to the local minimum of this dip
        while tau + 1 <= tau_max and cmnd[i, tau + 1] < cmnd[i, tau]:
            tau += 1
        # parabolic interpolation around tau
        if 1 <= tau < tau_max:
            a, b, c = cmnd[i, tau - 1], cmnd[i, tau], cmnd[i, tau + 1]
            denom = a - 2 * b + c
            shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            shift = np.clip(shift, -1, 1)
        else:
            shift = 0.0
        f0[i] = sr / (tau + shift)
    return f0


def yin_pitch_native(wav: np.ndarray, sr: int, hop: int,
                     fmin: float = 71.0, fmax: float = 800.0,
                     threshold: float = 0.15) -> np.ndarray:
    """YIN in C++ (``csrc/yin_pitch.cpp``, built into ``build/host/``
    first if missing; raises if g++ is missing or the build fails): f0
    per frame, computed in float64 and returned as float32 values in a
    float64 array."""
    wav32 = np.ascontiguousarray(wav, dtype=np.float32)
    n_frames = len(wav32) // hop + 1
    out = np.zeros(n_frames, dtype=np.float32)
    build.load_host("yin_pitch", _YIN_SIGNATURES).yin_pitch(
        wav32.ctypes.data_as(_F32P), len(wav32), sr, hop,
        ctypes.c_float(fmin), ctypes.c_float(fmax),
        ctypes.c_float(threshold), out.ctypes.data_as(_F32P), n_frames)
    return out.astype(np.float64)


def extractor_name() -> str:
    """Which backend extract_pitch() will use (stamped into stats.json so
    mixed-extractor datasets are detectable)."""
    if _pw is not None:
        return "pyworld_dio_stonemask"
    return "native_dio_stonemask"


def extract_pitch(wav: np.ndarray, sr: int, hop: int,
                  backend: str = "auto") -> np.ndarray:
    """Frame-rate F0 (0 where unvoiced), the reference's DIO+StoneMask
    recipe (reference: preprocessor/preprocessor.py:182-187).

    backend: "auto" = pyworld when installed (bit-exact reference parity),
    else the native numpy DIO+StoneMask port (audio/dio.py).  "yin" is the
    C++ YIN estimator (raises if it cannot be built) — a different
    algorithm; do not mix datasets across backends."""
    if backend == "auto":
        if _pw is not None:
            f0, t = _pw.dio(wav.astype(np.float64), sr,
                            frame_period=hop / sr * 1000)
            return _pw.stonemask(wav.astype(np.float64), f0, t, sr)
        from efficientspeech_tpu_torch.audio.dio import dio_stonemask

        return dio_stonemask(np.asarray(wav, np.float64), sr, hop)
    if backend == "yin":
        return yin_pitch_native(wav, sr, hop)
    raise ValueError(f"unknown pitch backend {backend!r}")


def interpolate_unvoiced(pitch: np.ndarray) -> np.ndarray:
    """Linear interpolation over unvoiced (0) frames with edge hold
    (reference: preprocessor/preprocessor.py:198-207)."""
    pitch = np.asarray(pitch, dtype=np.float64).copy()
    nonzero = np.where(pitch != 0)[0]
    if len(nonzero) == 0:
        return pitch
    pitch = np.interp(np.arange(len(pitch)), nonzero, pitch[nonzero])
    return pitch
