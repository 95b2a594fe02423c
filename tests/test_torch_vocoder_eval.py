"""The port's held-out vocoder eval (``eval/vocoder_eval.py``) against the
JAX package's: ``evaluate_pairs`` on pairs of unequal length through the
same generator weights, the padding invariance of the masked metrics,
and a generator that echoes the reference scoring zero."""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs in this process)

from efficientspeech_tpu.config import AudioConfig as JaxAudioConfig
from efficientspeech_tpu.config import HifiGanConfig as JaxHifiGanConfig
from efficientspeech_tpu.eval.vocoder_eval import (
    evaluate_pairs as jax_evaluate_pairs)
from efficientspeech_tpu.models.hifigan import HifiGanGenerator as JaxGen
from efficientspeech_tpu_torch.config import AudioConfig, HifiGanConfig
from efficientspeech_tpu_torch.eval.vocoder_eval import (
    evaluate_pairs, make_holdout_eval)
from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
from efficientspeech_tpu_torch.weights import init_params, to_jax_params

torch.set_num_threads(4)

HOP = 256


def _tone_pairs(lengths, n_mels=80, seed=0):
    """(mel float16 (T, 80), wav int16 (T·256,)) pairs: a 200 Hz tone
    with noise."""
    rng = np.random.default_rng(seed)
    pairs = []
    for t in lengths:
        mel = rng.normal(-4, 1.5, size=(t, n_mels)).astype(np.float16)
        tt = np.arange(t * HOP) / 22050.0
        wav = 0.4 * np.sin(2 * np.pi * 200.0 * tt)
        wav += 0.01 * rng.standard_normal(len(wav))
        pairs.append((mel, np.clip(wav * 32767, -32768, 32767)
                      .astype(np.int16)))
    return pairs


@pytest.fixture(scope="module")
def generator():
    """The width-16 generator from the port's seeded init, and its tree."""
    gen = init_params(HifiGanGenerator(HifiGanConfig(
        upsample_initial_channel=16)), 3)
    return gen, to_jax_params(gen)


def test_evaluate_pairs_matches_jax(generator):
    """Three pairs of 50, 150 and 90 frames in batches of 2 (each padded
    to 192 frames): every summary metric within 1e-4 relative of the JAX
    package's on the same weights, and the same keys and count."""
    gen, tree = generator
    pairs = _tone_pairs([50, 150, 90])
    want = jax_evaluate_pairs(
        JaxGen(JaxHifiGanConfig(upsample_initial_channel=16)), tree, pairs,
        JaxAudioConfig(), batch=2)
    got = evaluate_pairs(gen, pairs, AudioConfig(), batch=2)
    assert set(got) == set(want)
    assert got["n_utterances"] == want["n_utterances"] == 3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_metrics_do_not_depend_on_padding(generator):
    """The short pair scored alone (padded to 64 frames) and beside a long
    one in a 192-frame batch: its masked metrics agree within 1e-5."""
    gen, _ = generator
    short, long_ = _tone_pairs([50, 150], seed=1)
    alone = evaluate_pairs(gen, [short], AudioConfig(), batch=1)
    fn = make_holdout_eval(gen, AudioConfig())
    p = 192
    mel = np.zeros((2, p, 80), np.float32)
    wav = np.zeros((2, p * HOP), np.float32)
    n = np.zeros((2,), np.int64)
    for r, (m, w) in enumerate([short, long_]):
        mel[r, : m.shape[0]] = m.astype(np.float32)
        wav[r, : len(w)] = w.astype(np.float32) / 32767.0
        n[r] = m.shape[0]
    got = fn(torch.from_numpy(mel), torch.from_numpy(wav),
             torch.from_numpy(n))
    assert alone["mel_l1"] > 0.1
    for k in ("mel_l1", "sc_512", "sc_1024", "sc_2048", "logmag_512",
              "logmag_1024", "logmag_2048"):
        np.testing.assert_allclose(float(got[k][0]), alone[k], rtol=1e-5,
                                   err_msg=k)


class _Echo(torch.nn.Module):
    """A generator that returns a fixed waveform, whatever the mel."""

    def __init__(self, wav):
        super().__init__()
        self.wav = torch.nn.Parameter(torch.from_numpy(wav))

    def forward(self, mel):
        return self.wav


def test_echo_generator_scores_zero():
    """A generator that returns the reference audio scores 0 on every
    distance."""
    pairs = _tone_pairs([50])
    t = pairs[0][0].shape[0]
    wav = np.zeros((1, 64 * HOP), np.float32)
    wav[0, : t * HOP] = pairs[0][1].astype(np.float32) / 32767.0
    m = evaluate_pairs(_Echo(wav), pairs, AudioConfig(), batch=1)
    assert m["mel_l1"] < 1e-6 and m["mr_stft"] < 1e-6
    assert m["n_utterances"] == 1
    with pytest.raises(ValueError, match="no held-out pairs"):
        evaluate_pairs(_Echo(wav), [], AudioConfig())
