"""The port's ``eval/quality.py`` (a copy: host numpy) against the JAX
package's, function by function on seeded inputs.  Tolerance: bit-equal
(NaN where JAX gives NaN)."""

import numpy as np
import pytest

from efficientspeech_tpu.eval import quality as jax_quality
from efficientspeech_tpu_torch.eval import quality

SR, HOP = 22050, 256


def _log_mel(rng, frames, n_mels=80):
    return (rng.standard_normal((frames, n_mels)) - 4.0).astype(np.float32)


def _tone(rng, secs, hz):
    t = np.arange(int(SR * secs)) / SR
    f0 = hz + 20 * np.sin(2 * np.pi * 1.5 * t)
    return (0.4 * np.sin(2 * np.pi * np.cumsum(f0) / SR)
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def _same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _case_mel_cepstra(rng, n):
    return (_log_mel(rng, 17 + n),), {"n_coeffs": 12 + 6 * n}


def _case_dtw_path(rng, n):
    return (rng.random((9 + 5 * n, 13 - 2 * n)),), {}


def _case_mcd_dtw(rng, n):
    return (_log_mel(rng, 30 + 7 * n), _log_mel(rng, 41 - 3 * n)), {}


def _case_f0_frame_metrics(rng, n):
    f0_pred = np.where(rng.random(40) < 0.3, 0.0, rng.uniform(90, 250, 40))
    f0_ref = np.where(rng.random(38) < 0.3 * n, 0.0,
                      rng.uniform(90, 250, 38))
    _, path = jax_quality.mcd_dtw(_log_mel(rng, 40), _log_mel(rng, 38))
    return (f0_pred, f0_ref, path), {}


def _case_duration_mae(rng, n):
    real = rng.random(20) < (0.0 if n == 2 else 0.8)
    return (np.round(rng.uniform(0, 8, 20)), rng.integers(0, 9, 20),
            real), {}


def _case_log_mel_numpy(rng, n):
    return (_tone(rng, 0.4 + 0.3 * n, 160.0),), {"n_mels": 80 - 40 * (n == 1)}


def _case_utterance_quality(rng, n):
    gt = _log_mel(rng, 50)
    kw = {"dur_pred": np.round(rng.uniform(0, 6, 12)),
          "dur_gt": rng.integers(1, 7, 12)}
    if n >= 1:
        kw.update(wav_pred=_tone(rng, 46 * HOP / SR, 150.0),
                  wav_ref=_tone(rng, 50 * HOP / SR, 170.0))
    if n == 2:
        kw.update(phoneme_real=np.arange(12) < 9, floor=False)
    return (_log_mel(rng, 46), gt), kw


def _case_batch_quality(rng, n):
    per = [{"mcd_db": float(rng.uniform(3, 9)),
            "f0_rmse_hz": float("nan") if i % 2 else float(rng.uniform(5, 20)),
            "duration_mae_frames": float(rng.uniform(0, 2))}
           for i in range(3 + n)]
    per.append({"duration_mae_frames": 1.5})
    if n == 2:
        per = [{"f0_rmse_hz": float("nan")}]
    return (per,), {}


CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
         if name.startswith("_case_")}


def test_every_function_has_a_case():
    assert sorted(CASES) == sorted(quality.__all__) == \
        sorted(jax_quality.__all__)


@pytest.mark.parametrize("fn", sorted(CASES))
def test_bit_equal_to_jax(fn):
    """Three seeded cases of each function (edge cases among them: an
    all-PAD duration row, an all-NaN batch key, no floor)."""
    for n in range(3):
        args, kw = CASES[fn](np.random.default_rng(100 + n), n)
        want = getattr(jax_quality, fn)(*args, **kw)
        got = getattr(quality, fn)(*args, **kw)
        _same(got, want)
