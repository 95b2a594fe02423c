"""DIO + StoneMask F0 estimation (numpy port of the reference's extractor;
a copy of the JAX package's ``audio/dio.py``, float64 on the host).

The reference preprocessor extracts pitch with pyworld's DIO and refines it
with StoneMask (reference: preprocessor/preprocessor.py:182-187).  pyworld
is not installable here, so this module reimplements both algorithms from
their published descriptions (Morise et al., "DIO: a fast and reliable F0
estimator", and the StoneMask refinement used in WORLD):

DIO:
  1. Band decomposition: the signal is zero-phase low-pass filtered at a
     log-spaced ladder of boundary frequencies spanning [f0_floor, f0_ceil]
     (``channels_in_octave`` per octave).  A band whose cutoff sits just
     above the true F0 leaves a near-pure sinusoid at the fundamental.
  2. Four "event" F0 contours per band: intervals between negative→positive
     zero crossings, positive→negative crossings, peaks, and dips — each
     with sub-sample (linear-interp) event timing — interpolated to frame
     times.
  3. Candidate selection: per frame, the band whose four contours agree
     best (lowest relative stddev) wins; frames where even the best band
     disagrees beyond a threshold are unvoiced.
  4. Contour fixing: short voiced islands and single-frame octave jumps are
     removed.

StoneMask:
  Each voiced frame is refined by the instantaneous frequencies of the
  first harmonics: a 3-period Blackman-windowed segment is analyzed with
  two DFTs one sample apart (phase-difference instantaneous frequency) and
  the refined F0 is the amplitude-weighted mean of inst_freq(h·f0)/h over
  harmonics.  Two refinement passes, like WORLD.

This is an algorithmic port, not a bit-exact one: when ``pyworld`` IS
installed the preprocessor still prefers it, and ``stats.json`` records
which extractor produced the dataset (see data/preprocessor.py).
Accuracy on synthetic signals (pure/modulated sine, sweeps) is <1 Hz —
tested in tests/test_dio.py.
"""

from typing import Tuple

import numpy as np


def _fft_len(n: int) -> int:
    """Power-of-two FFT length with headroom (pocketfft is pathological on
    prime-ish sizes; the zero tail also absorbs the circular filter wrap)."""
    f = 1
    while f < n + 2048:
        f *= 2
    return f


def _lowpass_zero_phase(x: np.ndarray, fs: float, cutoff: float) -> np.ndarray:
    """FFT-domain zero-phase low-pass with a raised-cosine transition band
    [cutoff, 1.3*cutoff].  Zero phase keeps event times unbiased."""
    spec, nfft = _forward_fft(x)
    return _lowpass_from_spec(spec, nfft, len(x), fs, cutoff)


def _forward_fft(x: np.ndarray):
    """One shared forward FFT for all DIO bands (each band only differs in
    the frequency-domain mask)."""
    nfft = _fft_len(len(x))
    return np.fft.rfft(x, nfft), nfft


def _lowpass_from_spec(spec: np.ndarray, nfft: int, n: int, fs: float,
                       cutoff: float) -> np.ndarray:
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    h = np.clip((1.3 * cutoff - freqs) / (0.3 * cutoff), 0.0, 1.0)
    h = 0.5 - 0.5 * np.cos(np.pi * h)
    return np.fft.irfft(spec * h, nfft)[:n]


def _crossing_times(y: np.ndarray, fs: float, positive: bool) -> np.ndarray:
    """Sub-sample times of negative→positive (or positive→negative) zero
    crossings, via linear interpolation."""
    if positive:
        idx = np.where((y[:-1] <= 0) & (y[1:] > 0))[0]
    else:
        idx = np.where((y[:-1] >= 0) & (y[1:] < 0))[0]
    if len(idx) == 0:
        return np.empty(0)
    frac = -y[idx] / (y[idx + 1] - y[idx])
    return (idx + frac) / fs


def _event_contour(times: np.ndarray, frame_ts: np.ndarray) -> np.ndarray:
    """Interval F0 at event midpoints → interpolated to frame times;
    zeros when fewer than 2 events."""
    if len(times) < 2:
        return np.zeros(len(frame_ts))
    intervals = np.diff(times)
    good = intervals > 0
    if good.sum() < 1:
        return np.zeros(len(frame_ts))
    f0 = 1.0 / intervals[good]
    mid = (times[:-1] + times[1:])[good] * 0.5
    return np.interp(frame_ts, mid, f0)


def _band_candidate(y: np.ndarray, fs: float,
                    frame_ts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(candidate_f0, relative_disagreement) per frame for one band."""
    dy = np.diff(y)
    contours = np.stack([
        _event_contour(_crossing_times(y, fs, True), frame_ts),
        _event_contour(_crossing_times(y, fs, False), frame_ts),
        _event_contour(_crossing_times(dy, fs, False), frame_ts),  # peaks
        _event_contour(_crossing_times(dy, fs, True), frame_ts),   # dips
    ])
    mean = contours.mean(axis=0)
    ok = (contours > 0).all(axis=0) & (mean > 0)
    std = contours.std(axis=0)
    score = np.where(ok, std / np.maximum(mean, 1e-9), np.inf)
    return np.where(ok, mean, 0.0), score


def dio(x: np.ndarray, fs: int, frame_period: float = 5.0,
        f0_floor: float = 71.0, f0_ceil: float = 800.0,
        channels_in_octave: float = 2.0,
        voiced_threshold: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
    """DIO F0 track.  Returns (f0, temporal_positions) with
    n_frames = floor(len(x)/fs*1000/frame_period) + 1, pyworld-compatible.
    frame_period in ms."""
    x = np.asarray(x, np.float64)
    x = x - x.mean() if len(x) else x
    n_frames = int(len(x) / fs * 1000.0 / frame_period) + 1
    frame_ts = np.arange(n_frames) * frame_period / 1000.0

    n_bands = int(np.ceil(np.log2(f0_ceil / f0_floor)
                          * channels_in_octave)) + 1
    boundaries = f0_floor * 2.0 ** (np.arange(1, n_bands + 1)
                                    / channels_in_octave)

    best_f0 = np.zeros(n_frames)
    best_score = np.full(n_frames, np.inf)
    # silence gate: frames with negligible energy can't be voiced
    hop = int(round(fs * frame_period / 1000.0))
    energy = np.zeros(n_frames)
    for i in range(n_frames):
        seg = x[max(0, i * hop - hop): i * hop + hop]
        if len(seg):
            energy[i] = np.sqrt(np.mean(seg ** 2))
    # relative gate at -55 dB under the robust (95th-pct) peak: vocoder /
    # codec noise floors are quasi-periodic at ~-80 dB and would otherwise
    # read as voiced (measured on LJ_V2-vocoded silence,
    # tests/test_dio.py::test_dio_on_vocoded_natural_speech); real breathy
    # speech tails sit ≥ -40 dB, far above the gate
    peak = float(np.quantile(energy, 0.95)) if n_frames else 0.0
    silent = energy < max(1e-6, 10.0 ** (-55.0 / 20.0) * peak)

    spec, nfft = _forward_fft(x)
    for boundary in boundaries:
        y = _lowpass_from_spec(spec, nfft, len(x), fs, boundary * 1.1)
        cand, score = _band_candidate(y, fs, frame_ts)
        in_range = (cand >= f0_floor * 0.9) & (cand <= f0_ceil * 1.1) \
            & (cand <= boundary * 1.2)
        score = np.where(in_range, score, np.inf)
        better = score < best_score
        best_f0 = np.where(better, cand, best_f0)
        best_score = np.where(better, score, best_score)

    voiced = (best_score < voiced_threshold) & ~silent
    f0 = np.where(voiced, best_f0, 0.0)
    f0 = _fix_contour(f0)
    return f0, frame_ts


def _fix_contour(f0: np.ndarray, allowed_range: float = 0.1,
                 min_run: int = 3) -> np.ndarray:
    """DIO contour fixing (WORLD FixF0Contour, simplified): within a voiced
    run, a frame jumping more than ``allowed_range`` relative to the last
    kept frame is unvoiced (noise produces erratic interval contours that
    die here; real F0 moves ≲2%/frame), then voiced islands shorter than
    ``min_run`` frames are removed."""
    n = len(f0)

    def _jump_pass(vals):
        """Zero frames that jump >allowed_range vs the PREVIOUS CANDIDATE
        (not the previous kept frame — tracking candidates stops a single
        garbage frame from cascading over a whole legitimate run)."""
        out = vals.copy()
        prev = 0.0
        for i in range(n):
            v = vals[i]
            if v > 0:
                if prev > 0 and abs(v - prev) / prev > allowed_range:
                    out[i] = 0.0
                prev = v
            else:
                prev = 0.0
        return out

    fwd = _jump_pass(f0)
    bwd = _jump_pass(f0[::-1])[::-1]
    # keep a frame only when BOTH directions accept it (WORLD fixes forward
    # and backward and reconciles; noise rarely agrees both ways)
    f0 = np.where((fwd > 0) & (bwd > 0), f0, 0.0)
    i = 0
    while i < n:
        if f0[i] > 0:
            j = i
            while j < n and f0[j] > 0:
                j += 1
            if j - i < min_run:
                f0[i:j] = 0.0
            i = j
        else:
            i += 1
    return f0


def stonemask(x: np.ndarray, f0: np.ndarray, temporal_positions: np.ndarray,
              fs: int, n_harmonics: int = 6, n_iter: int = 2) -> np.ndarray:
    """Refine a DIO F0 track with harmonic instantaneous frequencies
    (WORLD's StoneMask, reimplemented).  Unvoiced frames stay 0.

    Vectorized: frames are grouped by (quantized) analysis-window size per
    refinement pass so the two phase-difference DFTs run as batched 2-D
    FFTs — ~10× faster than per-frame FFTs at corpus scale, within the
    <1 Hz synthetic-accuracy budget (the window length only enters as the
    analysis span; quantizing it to 32 samples is immaterial)."""
    x = np.asarray(x, np.float64)
    out = np.asarray(f0, np.float64).copy()
    n = len(x)
    centers = np.round(np.asarray(temporal_positions) * fs).astype(np.int64)

    for _ in range(n_iter):
        voiced = np.where(out > 0)[0]
        if len(voiced) == 0:
            break
        halves = np.round(1.5 * fs / out[voiced]).astype(np.int64)
        # quantize UP so every window spans >= 1.5 periods (rounding down
        # biases the instantaneous frequency by over a Hz)
        halves = np.maximum(((halves + 31) // 32) * 32, 32)
        for half in np.unique(halves):
            sel = voiced[halves == half]
            seg_len = 2 * int(half) + 2
            lo = centers[sel] - half
            ok = (lo >= 0) & (lo + seg_len <= n) & (seg_len >= 18)
            sel, lo = sel[ok], lo[ok]
            if len(sel) == 0:
                continue
            seg = x[lo[:, None] + np.arange(seg_len)[None, :]]  # (k, L+1)
            w = np.blackman(seg_len - 1)
            y1 = seg[:, :-1] * w
            y2 = seg[:, 1:] * w
            nfft = 1 << int(np.ceil(np.log2((seg_len - 1) * 4)))
            s1 = np.fft.rfft(y1, nfft, axis=1)
            s2 = np.fft.rfft(y2, nfft, axis=1)
            df = fs / nfft
            # phase-difference instantaneous frequency per bin
            inst = np.angle(s2 * np.conj(s1)) * fs / (2 * np.pi)
            mag = np.abs(s1)

            f = out[sel]
            num = np.zeros(len(sel))
            den = np.zeros(len(sel))
            rows = np.arange(len(sel))
            n_bins = mag.shape[1]
            for h in range(1, n_harmonics + 1):
                target = h * f
                k = np.clip(np.round(target / df).astype(np.int64),
                            0, n_bins - 1)
                a = mag[rows, k]
                est = inst[rows, k] / h
                valid = (target <= fs / 2 - df) & (est > 0)
                num += np.where(valid, a * est, 0.0)
                den += np.where(valid, a, 0.0)
            new_f = np.where(den > 0, num / np.maximum(den, 1e-12), f)
            accept = (den > 0) & (new_f > 0.5 * f) & (new_f < 2.0 * f)
            out[sel] = np.where(accept, new_f, f)
    return out


def dio_stonemask(wav: np.ndarray, sr: int, hop: int,
                  f0_floor: float = 71.0,
                  f0_ceil: float = 800.0) -> np.ndarray:
    """The reference's exact extraction recipe
    (preprocessor/preprocessor.py:182-187) on the native implementation:
    DIO at frame_period = hop/sr*1000, then StoneMask."""
    f0, t = dio(wav, sr, frame_period=hop / sr * 1000.0,
                f0_floor=f0_floor, f0_ceil=f0_ceil)
    return stonemask(wav, f0, t, sr)
