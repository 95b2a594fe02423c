"""The port's pitch extraction against the JAX package's: DIO +
StoneMask and ``extract_pitch`` on the signals of tests/test_dio.py, the
numpy YIN, the C++ YIN (``csrc/yin_pitch.cpp``, built under build/host/
at first use) and its refusal to fall back when it cannot be built.

Tolerance: every function is host numpy (or the same C++ source) in
both packages, so each is held bit-equal."""

import numpy as np
import pytest

from efficientspeech_tpu.audio import dio as jax_dio
from efficientspeech_tpu.audio import pitch as jax_pitch
from efficientspeech_tpu_torch.audio import dio, pitch
from efficientspeech_tpu_torch.ops.kernels import build

SR, HOP = 22050, 256


def _t(secs):
    return np.arange(int(SR * secs)) / SR


def _sine(hz=180.0, secs=0.8):
    return 0.5 * np.sin(2 * np.pi * hz * _t(secs))


def _harmonic(hz=140.0):
    t = _t(0.8)
    x = sum((0.5 / h) * np.sin(2 * np.pi * hz * h * t) for h in range(1, 8))
    return x / np.abs(x).max()


def _chirp(inst):
    return 0.5 * np.sin(2 * np.pi * np.cumsum(inst) / SR)


def _boundary():
    tone = 0.5 * np.sin(2 * np.pi * 200 * _t(0.3))
    return np.concatenate([tone, np.zeros(int(SR * 0.3)), tone])


# the signals of tests/test_dio.py
SIGNALS = {
    "sine100": lambda: _sine(100.0),
    "sine340": lambda: _sine(340.0),
    "sine560": lambda: _sine(560.0),
    "harmonic": _harmonic,
    "sweep": lambda: _chirp(150.0 + 100.0 * _t(1.0)),
    "vibrato": lambda: _chirp(200.0 + 8.0 * np.sin(2 * np.pi * 5.0 * _t(1.0))),
    "noise": lambda: 0.3 * np.random.default_rng(0).standard_normal(
        int(SR * 0.5)),
    "silence": lambda: np.zeros(int(SR * 0.3)),
    "boundary": _boundary,
    "odd_length": lambda: np.sin(2 * np.pi * 150 * np.arange(22300) / SR),
}


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_dio_stonemask_bit_equal_to_jax(name):
    x = SIGNALS[name]()
    want = jax_dio.dio_stonemask(x, SR, HOP)
    got = dio.dio_stonemask(x, SR, HOP)
    np.testing.assert_array_equal(got, want)
    f0, ts = dio.dio(x, SR, frame_period=HOP / SR * 1000.0)
    jf0, jts = jax_dio.dio(x, SR, frame_period=HOP / SR * 1000.0)
    np.testing.assert_array_equal(f0, jf0)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(dio.stonemask(x, f0, ts, SR),
                                  jax_dio.stonemask(x, jf0, jts, SR))


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_extract_pitch_bit_equal_to_jax(name):
    """The default backend (pyworld where installed, else DIO) of both
    packages, on float32 input as the preprocessor passes it, and the
    unvoiced interpolation after it."""
    assert pitch.extractor_name() == jax_pitch.extractor_name()
    x = SIGNALS[name]().astype(np.float32)
    want = jax_pitch.extract_pitch(x, SR, HOP)
    got = pitch.extract_pitch(x, SR, HOP)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pitch.interpolate_unvoiced(got),
                                  jax_pitch.interpolate_unvoiced(want))


@pytest.mark.parametrize("name", ["sine100", "harmonic", "vibrato", "noise",
                                  "boundary"])
def test_yin_numpy_bit_equal_to_jax(name):
    x = SIGNALS[name]()
    np.testing.assert_array_equal(pitch.yin_pitch_numpy(x, SR, HOP),
                                  jax_pitch.yin_pitch_numpy(x, SR, HOP))


@pytest.mark.parametrize("name", ["sine100", "sine560", "harmonic",
                                  "vibrato", "noise", "silence"])
def test_yin_cpp_matches_jax(name):
    """The port's C++ YIN, a copy of native/pitch.cpp, is bit-equal to the
    JAX package's C++ YIN where that builds; against the numpy YIN (the
    JAX package's fallback) it agrees on voicing and, voiced, within the
    float32 rounding of its result (1e-5 relative)."""
    x = SIGNALS[name]()
    got = pitch.yin_pitch_native(x, SR, HOP)
    assert got.dtype == np.float64 and got.shape == (len(x) // HOP + 1,)
    assert build._host_lib_path("yin_pitch", build._gxx()).exists()
    np.testing.assert_array_equal(pitch.extract_pitch(x, SR, HOP,
                                                      backend="yin"), got)
    native = jax_pitch.yin_pitch_native(x, SR, HOP)
    if native is not None:
        np.testing.assert_array_equal(got, native)
    ref = jax_pitch.yin_pitch_numpy(x, SR, HOP)
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_yin_build_failure_raises(monkeypatch, tmp_path):
    """A missing compiler or a failed build raises: there is no quiet
    numpy fallback."""
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "HOST_BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "yin_pitch.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for yin_pitch"):
        pitch.extract_pitch(_sine(), SR, HOP, backend="yin")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        pitch.yin_pitch_native(_sine(), SR, HOP)
    with pytest.raises(ValueError, match="unknown pitch backend"):
        pitch.extract_pitch(_sine(), SR, HOP, backend="crepe")
