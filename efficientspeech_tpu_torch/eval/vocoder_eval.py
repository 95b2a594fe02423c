"""Held-out vocoder quality eval: mel L1 and the multi-resolution STFT
distance (counterpart of the JAX package's ``eval/vocoder_eval.py``).

``train_vocoder --from-acoustic --holdout-frac`` holds out a slice of the
teacher-forced (mel, audio) pairs and scores the generator on them before
and after fine-tuning.  Metrics per held-out utterance, masked to its
true length in a static padded batch:

- ``mel_l1``    the L1 between the training-scale log-mels of the
                vocoded and of the ground-truth wav;
- ``sc_N``      spectral convergence at FFT size N;
- ``logmag_N``  log-STFT-magnitude L1 at FFT size N;
- ``mr_stft``   mean(sc) + mean(logmag) over the three resolutions.

Everything runs on the generator's device over one static padded shape,
with one read to the host per batch.
"""

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from efficientspeech_tpu_torch.audio.stft import stft_magnitude
from efficientspeech_tpu_torch.config import AudioConfig
from efficientspeech_tpu_torch.training.vocoder import (
    STFT_RESOLUTIONS, make_mel_fn)

RESOLUTIONS: Tuple[Tuple[int, int, int], ...] = STFT_RESOLUTIONS


def make_holdout_eval(gen: nn.Module, audio: AudioConfig):
    """Per-batch eval: ``eval_fn(mel, wav_ref, n_frames)`` → dict of
    per-utterance metric tensors, on the generator's device.

    mel: (B, P, n_mels) teacher-forced acoustic mels, zero-padded;
    wav_ref: (B, P·hop) aligned ground-truth audio; n_frames: (B,) true
    mel lengths (0 marks an all-pad row, which the caller leaves out).
    ``gen`` maps mel to wav (B, P·hop)."""
    mel_of = make_mel_fn(audio, next(gen.parameters()).device)
    hop = audio.hop_length

    @torch.no_grad()
    def eval_fn(mel, wav_ref, n_frames) -> Dict[str, torch.Tensor]:
        y = gen(mel)                                     # (B, P·hop)
        n_samples = n_frames * hop
        t = mel.shape[1] * hop
        smask = (torch.arange(t, device=mel.device)[None, :]
                 < n_samples[:, None])
        y = torch.where(smask, y, torch.zeros_like(y))
        w = torch.where(smask, wav_ref, torch.zeros_like(wav_ref))

        out = {}
        my, mw = mel_of(y), mel_of(w)                    # (B, F, M)
        fmask = (torch.arange(my.shape[1], device=mel.device)[None, :]
                 < n_frames[:, None])
        diff = torch.abs(my - mw) * fmask[..., None]
        out["mel_l1"] = diff.sum((1, 2)) / torch.clamp(
            n_frames * my.shape[2], min=1)

        for n_fft, hop_r, win in RESOLUTIONS:
            sy = stft_magnitude(y, n_fft, hop_r, win)
            sw = stft_magnitude(w, n_fft, hop_r, win)
            n_fr = torch.div(n_samples, hop_r, rounding_mode="floor")
            fm = (torch.arange(sy.shape[1], device=mel.device)[None, :]
                  < n_fr[:, None])[..., None]
            sy, sw = sy * fm, sw * fm
            num = torch.sqrt(((sw - sy) ** 2).sum((1, 2)))
            den = torch.sqrt((sw ** 2).sum((1, 2)))
            out[f"sc_{n_fft}"] = num / torch.clamp(den, min=1e-8)
            lm = torch.abs(torch.log(torch.clamp(sy, min=1e-5))
                           - torch.log(torch.clamp(sw, min=1e-5))) * fm
            cnt = torch.clamp(n_fr * sy.shape[2], min=1)
            out[f"logmag_{n_fft}"] = lm.sum((1, 2)) / cnt
        return out

    return eval_fn


def evaluate_pairs(gen: nn.Module,
                   pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                   audio: AudioConfig, batch: int = 8,
                   eval_fn=None) -> Dict[str, float]:
    """Score ``gen`` on held-out (mel float16 (T, M), wav int16 (T·hop,))
    pairs (``train_vocoder.build_acoustic_pairs``'s format).

    Every pair is padded into one static (batch, P, M) shape, P the
    longest pair's frames rounded up to 64 (at least 64), and the
    true-length-masked per-utterance metrics are averaged.  Pass a premade
    ``eval_fn`` (from :func:`make_holdout_eval`) to reuse it across the
    before and after passes."""
    if not pairs:
        raise ValueError("no held-out pairs to evaluate")
    dev = next(gen.parameters()).device
    hop = audio.hop_length
    n_mels = pairs[0][0].shape[1]
    p = max(64, int(-(-max(m.shape[0] for m, _ in pairs) // 64) * 64))
    if eval_fn is None:
        eval_fn = make_holdout_eval(gen, audio)

    per_utt: List[Dict[str, float]] = []
    for lo in range(0, len(pairs), batch):
        chunk = pairs[lo: lo + batch]
        mel = np.zeros((batch, p, n_mels), np.float32)
        wav = np.zeros((batch, p * hop), np.float32)
        n_frames = np.zeros((batch,), np.int64)
        for r, (m, w) in enumerate(chunk):
            t = m.shape[0]
            mel[r, :t] = m.astype(np.float32)
            wav[r, : t * hop] = w.astype(np.float32) / 32767.0
            n_frames[r] = t
        got = eval_fn(torch.from_numpy(mel).to(dev),
                      torch.from_numpy(wav).to(dev),
                      torch.from_numpy(n_frames).to(dev))
        keys = sorted(got)
        host = torch.stack([got[k].float() for k in keys]).cpu().numpy()
        for r in range(len(chunk)):
            per_utt.append({k: float(host[i, r])
                            for i, k in enumerate(keys)})

    summary = {k: float(np.mean([u[k] for u in per_utt]))
               for k in per_utt[0]}
    scs = [summary[f"sc_{n}"] for n, _, _ in RESOLUTIONS]
    lms = [summary[f"logmag_{n}"] for n, _, _ in RESOLUTIONS]
    summary["mr_stft"] = float(np.mean(scs) + np.mean(lms))
    summary["n_utterances"] = len(per_utt)
    return summary
