"""Objective synthesis-quality metrics for trained models (a copy of the
JAX package's ``eval/quality.py``: host numpy, bit-equal by construction).

The reference's only quality artifact is human-listenable wav dumps per
validation pass (reference: model.py:246-271).  This module adds the
standard objective trio reported by TTS papers, computed on free-running
validation synthesis:

- **MCD-DTW** (dB): mel-cepstral distortion between the predicted and
  ground-truth mel spectrograms, DTW-aligned — free-running synthesis
  has its own duration, so frames cannot be compared index-to-index.
  Cepstra are the orthonormal DCT-II of the log-mel (c0/energy dropped),
  the common "mel-cepstra MCD" variant (no WORLD MCEPs needed).
- **F0 RMSE (Hz) + voicing F1**: DIO+StoneMask (audio/dio.py — validated
  on LJ_V2-vocoded speech, recall 0.967) on the *predicted* wav vs the
  *reconstruction* wav (ground-truth mel through the same vocoder).
  Using the vocoded ground truth as the F0 reference keeps the metric
  self-contained (no raw-corpus dependency at eval time) and cancels the
  vocoder's own F0 bias — both signals pass through the same vocoder, so
  the residual measures the acoustic model's pitch behaviour.  Frames
  are aligned with the MCD DTW path (standard practice).
- **Duration MAE (frames)**: per-phoneme predicted durations (the
  rounded duration-predictor output the length regulator actually uses)
  vs the aligner's ground-truth durations, over real (non-PAD) phonemes.

Everything here is host-side numpy on already-fetched arrays: the device
work (free-running forward + two vocoder calls) is exactly what the
validation wav dump already does.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "mel_cepstra",
    "dtw_path",
    "mcd_dtw",
    "f0_frame_metrics",
    "duration_mae",
    "log_mel_numpy",
    "utterance_quality",
    "batch_quality",
]

# 10 / ln(10) * sqrt(2): the MCD dB constant (difference of two cepstra,
# symmetric sum over quefrencies counted twice)
_MCD_K = 10.0 / np.log(10.0) * np.sqrt(2.0)


def mel_cepstra(log_mel: np.ndarray, n_coeffs: int = 24) -> np.ndarray:
    """Orthonormal DCT-II over the mel axis; drops c0 (frame energy).

    log_mel: (T, n_mels) natural-log mel spectrogram (the dataset /
    model representation).  Returns (T, n_coeffs).
    """
    log_mel = np.asarray(log_mel, np.float64)
    t_frames, n_mels = log_mel.shape
    k = np.arange(1, n_coeffs + 1)[:, None]  # skip c0
    m = np.arange(n_mels)[None, :]
    basis = np.cos(np.pi * k * (m + 0.5) / n_mels) * np.sqrt(2.0 / n_mels)
    return log_mel @ basis.T


def dtw_path(cost: np.ndarray) -> List[Tuple[int, int]]:
    """Classic DTW over a (T1, T2) pairwise-cost matrix with steps
    (1,0), (0,1), (1,1).  Returns the alignment path [(i, j), ...] from
    (0,0) to (T1-1, T2-1).

    The DP sweeps anti-diagonals (cells i+j == d depend only on
    d-1 and d-2), so each wavefront is one vectorized numpy update —
    O(T1*T2) work with only O(T1+T2) Python iterations (a row-ordered
    loop would be ~1M interpreter steps for two 1000-frame mels)."""
    t1, t2 = cost.shape
    # step choice per cell: 0 = diag, 1 = up (i-1, j), 2 = left (i, j-1)
    choice = np.zeros((t1, t2), np.int8)
    inf = np.inf
    # prev[i] = acc(i, d-1-i), prev2[i] = acc(i, d-2-i); index -1 → inf pad
    prev = np.full(t1 + 1, inf, np.float64)
    prev2 = np.full(t1 + 1, inf, np.float64)
    prev[1] = cost[0, 0]  # diagonal d = 0, shifted by one for the inf pad
    for d in range(1, t1 + t2 - 1):
        lo, hi = max(0, d - (t2 - 1)), min(d, t1 - 1)
        idx = np.arange(lo, hi + 1)
        c_up = prev[idx]          # acc(i-1, d-i): shifted index i-1+1
        c_left = prev[idx + 1]    # acc(i,   d-1-i)
        c_diag = prev2[idx]       # acc(i-1, d-1-(i-1))
        stack = np.stack([c_diag, c_up, c_left])
        ch = np.argmin(stack, axis=0).astype(np.int8)
        cur_vals = cost[idx, d - idx] + stack[ch, np.arange(len(idx))]
        choice[idx, d - idx] = ch
        cur = np.full(t1 + 1, inf, np.float64)
        cur[idx + 1] = cur_vals
        prev2, prev = prev, cur
    path = []
    i, j = t1 - 1, t2 - 1
    while True:
        path.append((i, j))
        if i == 0 and j == 0:
            break
        c = choice[i, j]
        if c == 0:
            i, j = i - 1, j - 1
        elif c == 1:
            i -= 1
        else:
            j -= 1
    path.reverse()
    return path


def mcd_dtw(mel_pred: np.ndarray, mel_gt: np.ndarray,
            n_coeffs: int = 24) -> Tuple[float, List[Tuple[int, int]]]:
    """MCD (dB) between two log-mel spectrograms of (generally) different
    lengths, averaged over the DTW alignment path.  Returns
    (mcd_db, path) — the path is reused for F0 alignment."""
    c_pred = mel_cepstra(mel_pred, n_coeffs)
    c_gt = mel_cepstra(mel_gt, n_coeffs)
    # pairwise Euclidean distances, (T1, T2)
    d2 = (np.sum(c_pred ** 2, 1)[:, None] + np.sum(c_gt ** 2, 1)[None, :]
          - 2.0 * (c_pred @ c_gt.T))
    dist = np.sqrt(np.maximum(d2, 0.0))
    path = dtw_path(dist)
    ii = np.fromiter((p[0] for p in path), np.int64, len(path))
    jj = np.fromiter((p[1] for p in path), np.int64, len(path))
    return float(_MCD_K * dist[ii, jj].mean()), path


def f0_frame_metrics(f0_pred: np.ndarray, f0_ref: np.ndarray,
                     path: Sequence[Tuple[int, int]]) -> Dict[str, float]:
    """F0 RMSE (Hz, over frames voiced in BOTH signals) and voicing F1
    (predicted-voiced against reference-voiced) along a DTW frame
    alignment.  f0 == 0 means unvoiced (DIO convention)."""
    ii = np.fromiter((p[0] for p in path), np.int64, len(path))
    jj = np.fromiter((p[1] for p in path), np.int64, len(path))
    # the F0 tracks may be 1-2 frames shorter than the mel (STFT edge
    # handling); clamp rather than drop the tail pairs
    fp = f0_pred[np.minimum(ii, len(f0_pred) - 1)]
    fr = f0_ref[np.minimum(jj, len(f0_ref) - 1)]
    vp, vr = fp > 0, fr > 0
    tp = float(np.sum(vp & vr))
    precision = tp / max(float(vp.sum()), 1.0)
    recall = tp / max(float(vr.sum()), 1.0)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    both = vp & vr
    rmse = (float(np.sqrt(np.mean((fp[both] - fr[both]) ** 2)))
            if both.any() else float("nan"))
    return {"f0_rmse_hz": rmse, "voicing_f1": f1,
            "voicing_precision": precision, "voicing_recall": recall}


def duration_mae(dur_pred: np.ndarray, dur_gt: np.ndarray,
                 real: np.ndarray) -> float:
    """Mean |predicted - ground-truth| duration in frames over real
    (non-PAD) phonemes.  dur_pred is the rounded predictor output the
    length regulator consumed; dur_gt the aligner durations."""
    real = np.asarray(real, bool)
    if not real.any():
        return float("nan")
    diff = np.abs(np.asarray(dur_pred, np.float64)
                  - np.asarray(dur_gt, np.float64))
    return float(diff[real].mean())


def log_mel_numpy(wav: np.ndarray, sr: int = 22050, n_fft: int = 1024,
                  hop: int = 256, win: int = 1024, n_mels: int = 80,
                  fmin: float = 0.0, fmax: float = 8000.0) -> np.ndarray:
    """Host-side log-mel of a waveform, matching audio/stft.py's
    MelSpectrogram transform exactly (reflect center-pad, periodic Hann,
    slaney filterbank, log(clamp(., 1e-5))) — used to re-analyze vocoded
    audio for the reconstruction-floor MCD without touching the device.

    wav: (T,) float in [-1, 1].  Returns (frames, n_mels)."""
    from efficientspeech_tpu_torch.audio.mel import mel_filterbank

    wav = np.asarray(wav, np.float64)
    pad = n_fft // 2
    y = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    n = np.arange(win)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)
    if win < n_fft:
        lpad = (n_fft - win) // 2
        window = np.pad(window, (lpad, n_fft - win - lpad))
    mag = np.abs(np.fft.rfft(y[idx] * window, n=n_fft, axis=-1))
    basis = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    return np.log(np.clip(mag @ basis.T, 1e-5, None))


def utterance_quality(mel_pred: np.ndarray, mel_gt: np.ndarray,
                      dur_pred: Optional[np.ndarray] = None,
                      dur_gt: Optional[np.ndarray] = None,
                      phoneme_real: Optional[np.ndarray] = None,
                      wav_pred: Optional[np.ndarray] = None,
                      wav_ref: Optional[np.ndarray] = None,
                      sr: int = 22050, hop: int = 256,
                      n_coeffs: int = 24,
                      floor: bool = True) -> Dict[str, float]:
    """All metrics for one utterance.  mel_* are (T, n_mels) log-mels
    trimmed to their valid lengths.  wav_ref is the vocoded ground-truth
    mel (see module docstring); omit the wavs to skip the F0 metrics.

    ``floor`` (with wav_ref): also report ``mcd_floor_db`` — the MCD of
    the RECONSTRUCTION (ground-truth mel vocoded, then re-analyzed to
    log-mel on the host) against the ground-truth mel, through the same
    DTW.  This is the corpus+vocoder reconstruction floor: the part of
    mcd_db no acoustic model can remove.  Read mcd_db - mcd_floor_db as
    the acoustic model's own gap."""
    out: Dict[str, float] = {}
    mcd, path = mcd_dtw(mel_pred, mel_gt, n_coeffs)
    out["mcd_db"] = mcd
    if floor and wav_ref is not None and mel_gt.shape[0] >= 2:
        n_mels = mel_gt.shape[1]
        mel_rec = log_mel_numpy(wav_ref, sr=sr, hop=hop, n_mels=n_mels)
        out["mcd_floor_db"] = mcd_dtw(mel_rec, mel_gt, n_coeffs)[0]
    if wav_pred is not None and wav_ref is not None:
        from efficientspeech_tpu_torch.audio.dio import dio_stonemask

        f0_pred = dio_stonemask(np.asarray(wav_pred, np.float64), sr, hop)
        f0_ref = dio_stonemask(np.asarray(wav_ref, np.float64), sr, hop)
        out.update(f0_frame_metrics(f0_pred, f0_ref, path))
    if dur_pred is not None and dur_gt is not None:
        if phoneme_real is None:
            phoneme_real = np.ones(len(dur_gt), bool)
        out["duration_mae_frames"] = duration_mae(dur_pred, dur_gt,
                                                  phoneme_real)
    return out


def batch_quality(per_utt: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """NaN-aware mean over per-utterance metric dicts (an utterance with
    no voiced frames reports F0 RMSE = NaN and is excluded from that
    mean only)."""
    keys = sorted({k for d in per_utt for k in d})
    out = {}
    for k in keys:
        vals = np.array([d[k] for d in per_utt if k in d], np.float64)
        vals = vals[np.isfinite(vals)]
        out[k] = float(vals.mean()) if len(vals) else float("nan")
    return out
