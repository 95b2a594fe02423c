"""Batched STFT, inverse STFT, Griffin-Lim and mel + energy extraction in
PyTorch (counterpart of the JAX package's ``audio/stft.py``).

The same formulation as there: reflect-pad → frame (``unfold``) → window
→ ``torch.fft.rfft`` (cuFFT on the card).  Every function runs on the
device of the tensors it is given; ``MelSpectrogram`` holds its filterbank
on the device it was built for, the card unless ``device="cpu"``.

The mel product runs in float64 and is rounded to float32 after it: the
JAX package runs it at ``Precision.HIGHEST`` (float32 products), and a
float32 product on the card would take TF32 whenever a caller has set
``torch.backends.cuda.matmul.allow_tf32``.  Float64 products cannot, and
round to float32 values that JAX's agree with to the last few ulps.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from efficientspeech_tpu_torch.audio.mel import mel_filterbank
from efficientspeech_tpu_torch.device import resolve_device


def hann_window(win_length: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Periodic (fftbins=True) Hann, matching scipy get_window('hann', n)."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)


def _window(win_length: int, n_fft: int, like: torch.Tensor
            ) -> torch.Tensor:
    """The Hann window centre-padded to ``n_fft``."""
    window = hann_window(win_length, like.dtype, like.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def _frame(y: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(B, T) → (B, frames, frame_length) strided framing."""
    return y.unfold(-1, frame_length, hop)


def _reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0]


def stft(y: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
         win_length: int = 1024) -> torch.Tensor:
    """(B, T) float in [-1, 1] → complex (B, frames, 1 + n_fft//2).

    Center-padded by reflect n_fft//2 like the reference/librosa
    (reference: audio/stft.py:60-66).
    """
    frames = _frame(_reflect_pad(y, n_fft // 2), n_fft, hop_length)
    return torch.fft.rfft(frames * _window(win_length, n_fft, frames),
                          n=n_fft, dim=-1)


def stft_magnitude(y: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                   win_length: int = 1024) -> torch.Tensor:
    return stft(y, n_fft, hop_length, win_length).abs()


def istft(magnitude: torch.Tensor, phase: torch.Tensor, n_fft: int = 1024,
          hop_length: int = 256, win_length: int = 1024) -> torch.Tensor:
    """Inverse STFT with window-sumsquare correction
    (reference: audio/stft.py:84-123).  magnitude/phase: (B, frames, bins)."""
    spec = magnitude * torch.exp(1j * phase.to(torch.complex64))
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)         # (B, F, n_fft)
    window = _window(win_length, n_fft, frames)
    frames = frames * window

    b, n_frames, _ = frames.shape
    t = n_fft + hop_length * (n_frames - 1)
    # overlap-add
    idx = (torch.arange(n_frames, device=frames.device)[:, None] * hop_length
           + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    sig = torch.zeros((b, t), dtype=frames.dtype,
                      device=frames.device).index_add_(
        1, idx, frames.reshape(b, -1))
    wss = torch.zeros(t, dtype=frames.dtype, device=frames.device).index_add_(
        0, idx, (window ** 2).repeat(n_frames))
    sig = torch.where(wss > 1e-11, sig / wss.clamp_min(1e-11), sig)
    pad = n_fft // 2
    return sig[:, pad: t - pad]


def griffin_lim(magnitude: torch.Tensor, n_iters: int = 30, n_fft: int = 1024,
                hop_length: int = 256, win_length: int = 1024,
                phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase recovery (reference: audio/audio_processing.py:66-82).
    magnitude: (B, frames, bins).  ``phase`` is the initial phase, by
    default uniform in [-π, π) from a ``torch.Generator`` seeded by 0."""
    if phase is None:
        gen = torch.Generator().manual_seed(0)
        phase = (torch.rand(magnitude.shape, generator=gen,
                            dtype=magnitude.dtype) * (2 * np.pi) - np.pi
                 ).to(magnitude.device)
    for _ in range(n_iters):
        sig = istft(magnitude, phase, n_fft, hop_length, win_length)
        rec = stft(sig, n_fft, hop_length, win_length)
        phase = torch.angle(rec)[:, :magnitude.shape[1], :]
    return istft(magnitude, phase, n_fft, hop_length, win_length)


def mel_to_wav_griffin_lim(mel: torch.Tensor, mel_basis: torch.Tensor,
                           n_iters: int = 60, n_fft: int = 1024,
                           hop_length: int = 256, win_length: int = 1024,
                           phase: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Vocoder-free mel → wav debug path (reference: audio/tools.py:21-34).

    mel: (B, frames, n_mels) log-compressed; mel_basis: (n_mels, bins).
    """
    linear = torch.exp(mel)  # dynamic_range_decompression, C=1
    mag = torch.einsum("btm,mf->btf", linear,
                       torch.linalg.pinv(mel_basis).T).clamp_min(0.0)
    return griffin_lim(mag, n_iters=n_iters, n_fft=n_fft,
                       hop_length=hop_length, win_length=win_length,
                       phase=phase)


class MelSpectrogram:
    """Batched mel + energy extraction (reference: audio/stft.py:137-182).

    mel = log(clamp(mel_basis @ |STFT|, 1e-5)); energy = ||frame||_2.
    Call with (B, T) float32 waveforms in [-1, 1] on ``self.device``.
    """

    def __init__(self, filter_length: int = 1024, hop_length: int = 256,
                 win_length: int = 1024, n_mel_channels: int = 80,
                 sampling_rate: int = 22050, mel_fmin: float = 0.0,
                 mel_fmax: Optional[float] = 8000.0, device=None):
        self.device = resolve_device(device)
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.mel_basis = torch.from_numpy(mel_filterbank(
            sampling_rate, filter_length, n_mel_channels, mel_fmin,
            mel_fmax)).to(self.device)
        self._basis64 = self.mel_basis.double()

    def _mel_energy(self, frames: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        mag = torch.fft.rfft(
            frames * _window(self.win_length, self.filter_length, frames),
            n=self.filter_length, dim=-1).abs()
        mel = torch.einsum("mf,btf->btm", self._basis64, mag.double())
        mel = torch.log(mel.float().clamp_min(1e-5))
        energy = torch.linalg.vector_norm(mag, dim=-1)
        return mel, energy

    def __call__(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """y (B, T) → (mel (B, frames, n_mels), energy (B, frames))."""
        return self._mel_energy(_frame(
            _reflect_pad(y, self.filter_length // 2), self.filter_length,
            self.hop_length))

    @torch.no_grad()
    def extract_bucketed(self, y: np.ndarray, multiple: int = 16384
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Exactly ``__call__`` on a host array, but with the wav padded to
        a length bucket: the reflect center-pad happens on the host at the
        TRUE length, and the zero tail starts beyond the last valid frame's
        window, so every returned frame equals the unbucketed call's while
        a corpus of distinct lengths makes one cuFFT plan per bucket, not
        one per utterance.  Returns host arrays, fetched in one read."""
        y = np.asarray(y)
        t = y.shape[-1]
        pad = self.filter_length // 2
        n_frames = t // self.hop_length + 1
        y_ref = np.pad(y, ((0, 0), (pad, pad)), mode="reflect")
        target = ((y_ref.shape[-1] + multiple - 1) // multiple) * multiple
        y_buck = np.pad(y_ref, ((0, 0), (0, target - y_ref.shape[-1])))
        mel, energy = self._mel_energy(_frame(
            torch.from_numpy(np.ascontiguousarray(y_buck, np.float32)).to(
                self.device), self.filter_length, self.hop_length))
        both = torch.cat([mel, energy[..., None]], dim=-1)[:, :n_frames]
        both = both.cpu().numpy()
        return both[..., :-1], both[..., -1]
