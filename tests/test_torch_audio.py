"""The port's audio DSP (``audio/stft.py`` in PyTorch, ``audio/mel.py`` a
copy) against the JAX package's on seeded signals, on the CPU.

Tolerances: the filterbank is the same numpy and is held bit-equal.  The
STFT, its inverse and Griffin-Lim run two FFT libraries in float32: the
window to 1 ulp (6e-8), spectra to 1e-6 of their peak, waveforms to 1e-5
absolute (Griffin-Lim's from the same initial phase: 1e-4, its angle
rounds where a bin's magnitude is tiny).  The mel extractor is held to
1e-4 absolute on the log-mel and 1e-5 relative on the energy; the
bucketed call to the unbucketed one exactly (the same frames)."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientspeech_tpu.audio.mel import mel_filterbank as jax_filterbank
from efficientspeech_tpu_torch.audio import stft
from efficientspeech_tpu_torch.audio.mel import mel_filterbank

# the package's __init__ re-exports a function named stft over the module
jax_stft = importlib.import_module("efficientspeech_tpu.audio.stft")

torch.set_num_threads(2)

SR = 22050
LOG_MEL_ATOL = 1e-4
ENERGY_RTOL = 1e-5


def _speechlike(secs, seed=0, batch=1):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * secs)) / SR
    rows = []
    for b in range(batch):
        f0 = 140 + 30 * b + 25 * np.sin(2 * np.pi * rng.uniform(0.8, 2) * t)
        x = sum((0.3 / h) * np.sin(2 * np.pi * np.cumsum(f0 * h) / SR)
                for h in range(1, 6))
        rows.append(x * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2)
                    + 0.01 * rng.standard_normal(len(t)))
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("args", [(22050, 1024, 80, 0.0, 8000.0),
                                  (16000, 512, 40, 50.0, None),
                                  (24000, 2048, 128, 0.0, 12000.0)])
def test_mel_filterbank_bit_equal(args):
    np.testing.assert_array_equal(mel_filterbank(*args),
                                  jax_filterbank(*args))


@pytest.mark.parametrize("win", [1024, 800])
def test_hann_and_stft_match_jax(win):
    np.testing.assert_allclose(stft.hann_window(win).numpy(),
                               np.asarray(jax_stft.hann_window(win)),
                               rtol=0, atol=6e-8)
    y = _speechlike(0.9, batch=2)
    want = np.asarray(jax_stft.stft(jnp.asarray(y), win_length=win))
    got = stft.stft(torch.from_numpy(y), win_length=win).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(
        stft.stft_magnitude(torch.from_numpy(y), win_length=win).numpy(),
        np.abs(want), rtol=0, atol=1e-6 * np.abs(want).max())


def test_istft_round_trip_matches_jax():
    y = _speechlike(0.7, seed=1, batch=2)
    spec = np.asarray(jax_stft.stft(jnp.asarray(y)))
    mag = np.abs(spec).astype(np.float32)
    phase = np.angle(spec).astype(np.float32)
    want = np.asarray(jax_stft.istft(jnp.asarray(mag), jnp.asarray(phase)))
    got = stft.istft(torch.from_numpy(mag), torch.from_numpy(phase)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the round trip gives the signal back
    np.testing.assert_allclose(got, y[:, :got.shape[1]], rtol=0, atol=1e-5)


def _jax_phase(shape):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape,
                                         jnp.float32, -np.pi, np.pi))


def test_griffin_lim_matches_jax():
    y = _speechlike(0.5, seed=2)
    mag = np.abs(np.asarray(jax_stft.stft(jnp.asarray(y)))).astype(
        np.float32)
    want = np.asarray(jax_stft.griffin_lim(jnp.asarray(mag), n_iters=8))
    got = stft.griffin_lim(torch.from_numpy(mag), n_iters=8,
                           phase=torch.from_numpy(_jax_phase(mag.shape)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    seeded = stft.griffin_lim(torch.from_numpy(mag), n_iters=2)
    assert seeded.shape == got.shape and torch.isfinite(seeded).all()


def test_mel_to_wav_griffin_lim_matches_jax():
    y = _speechlike(0.5, seed=3)
    basis = mel_filterbank(SR, 1024, 80, 0.0, 8000.0)
    mel, _ = jax_stft.MelSpectrogram()(jnp.asarray(y))
    mel = np.asarray(mel)
    want = np.asarray(jax_stft.mel_to_wav_griffin_lim(
        jnp.asarray(mel), jnp.asarray(basis), n_iters=4))
    got = stft.mel_to_wav_griffin_lim(
        torch.from_numpy(mel), torch.from_numpy(basis), n_iters=4,
        phase=torch.from_numpy(_jax_phase(mel.shape[:2] + (513,))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("secs", [0.25, 1.3, 4.7])
def test_mel_spectrogram_matches_jax(secs):
    """``__call__`` and ``extract_bucketed`` against JAX's
    ``extract_bucketed`` (log-mel 1e-4, energy 1e-5 relative); the
    bucketed call equals the unbucketed one."""
    y = _speechlike(secs, seed=4, batch=2)
    want_mel, want_energy = jax_stft.MelSpectrogram().extract_bucketed(y)
    ext = stft.MelSpectrogram(device="cpu")
    mel, energy = ext.extract_bucketed(y)
    assert mel.shape == want_mel.shape == (2, y.shape[1] // 256 + 1, 80)
    assert mel.dtype == energy.dtype == np.float32
    np.testing.assert_allclose(mel, want_mel, rtol=0, atol=LOG_MEL_ATOL)
    np.testing.assert_allclose(energy, want_energy, rtol=ENERGY_RTOL)
    full_mel, full_energy = ext(torch.from_numpy(y))
    np.testing.assert_array_equal(full_mel.numpy(), mel)
    np.testing.assert_array_equal(full_energy.numpy(), energy)


def test_mel_product_is_not_tf32(monkeypatch):
    """The mel product runs in float64, whatever a caller set for float32
    products; the default device is the card and raises without one."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    ext = stft.MelSpectrogram(device="cpu")
    assert ext._basis64.dtype == torch.float64
    y = _speechlike(0.3, seed=5)
    mel, _ = ext(torch.from_numpy(y))
    want, _ = jax_stft.MelSpectrogram()(jnp.asarray(y))
    np.testing.assert_allclose(mel.numpy(), np.asarray(want), rtol=0,
                               atol=LOG_MEL_ATOL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stft.MelSpectrogram()
