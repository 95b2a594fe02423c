"""The slice as a whole: the port's Synthesizer against the JAX package's
on the same parameters, and the wire codecs against the JAX encoders."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientspeech_tpu.audio.transfer import (
    encode_device as jax_encode_device)
from efficientspeech_tpu.config import HifiGanConfig as JaxHifiGanConfig
from efficientspeech_tpu.infer import build_synthesizer as jax_build
from efficientspeech_tpu.models.hifigan import HifiGanGenerator as JaxGen
from efficientspeech_tpu_torch.audio.transfer import (
    decode_host, encode_device)
from efficientspeech_tpu_torch.config import HifiGanConfig
from efficientspeech_tpu_torch.infer import build_synthesizer

torch.set_num_threads(2)

# ResBlock1 layout at small channels (the fixture of the ONNX export test)
SMALL_HIFIGAN = dict(upsample_rates=(8, 8),
                     upsample_kernel_sizes=(16, 16),
                     upsample_initial_channel=32,
                     resblock_kernel_sizes=(3, 5),
                     resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))


def _small_setup(synth):
    synth.phoneme_buckets = (16,)
    synth.mel_expansion = 8
    synth.spec_min_frames = 128
    return synth


@pytest.fixture(scope="module")
def synths():
    h_cfg = JaxHifiGanConfig(**SMALL_HIFIGAN)
    jsynth = _small_setup(jax_build(preset="tiny", hifigan_checkpoint="",
                                    dtype=jnp.float32,
                                    bench_duration_bias=4.0))
    shapes = jax.eval_shape(lambda: JaxGen(h_cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 80)))["params"])
    rng = np.random.default_rng(0)

    def leaf(path, s):
        if path[-1].key == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    params = dict(jsynth.params)
    params["hifigan"] = jax.tree_util.tree_map_with_path(leaf, shapes)
    jsynth.params = params
    jsynth.hifigan_cfg = h_cfg
    jsynth.transfer = "f32"

    psynth = _small_setup(build_synthesizer(
        preset="tiny", params=params,
        hifigan_cfg=HifiGanConfig(**SMALL_HIFIGAN), dtype=torch.float32,
        transfer="f32", vocoder_mode="folded", device="cpu"))
    return jsynth, psynth


def test_synthesize_ids_matches_jax(synths):
    jsynth, psynth = synths
    rng = np.random.default_rng(5)
    seq = rng.integers(70, 146, size=12).astype(np.int32)
    wav_j, mel_len_j, _ = jsynth.synthesize_ids(seq)
    wav_p, mel_len_p, _ = psynth.synthesize_ids(seq)
    assert mel_len_p == mel_len_j > 0
    hop = psynth.hifigan_cfg.total_upsample
    assert wav_p.shape == wav_j.shape == (mel_len_j * hop,)
    np.testing.assert_allclose(wav_p, wav_j, rtol=1e-3, atol=2e-4)


def test_tts_end_to_end(synths):
    _, psynth = synths
    wav, info = psynth.tts("Hello world, 42 dogs.")
    assert info["phoneme_len"] > 5 and info["mel_len"] > 0
    assert wav.shape == (info["mel_len"] * psynth.hifigan_cfg.total_upsample,)
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0


@pytest.mark.parametrize("fmt", ["int16", "mulaw", "f32"])
def test_wire_codecs_bit_equal_to_jax(fmt):
    rng = np.random.default_rng(9)
    wav = np.concatenate([
        rng.uniform(-1.2, 1.2, 4096),
        [-1.0, 1.0, 0.0, -0.0, 0.5, -0.5, 32767 / 32768, 1 / 32768],
    ]).astype(np.float32)
    want = np.asarray(jax_encode_device(jnp.asarray(wav), fmt))
    got = encode_device(torch.from_numpy(wav), fmt).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    back = decode_host(got, fmt)
    assert back.dtype == np.float32 and back.shape == wav.shape


def test_kernel_route_matches_plain_route(synths, monkeypatch):
    """With the kernel threshold lowered, synthesize_ids routes the
    vocoder through the kernel wrappers (their plain versions on the CPU,
    launching nothing) and gives the plain route's waveform."""
    from efficientspeech_tpu_torch import infer
    from efficientspeech_tpu_torch.ops.kernels import folded_matmul, mrf_block

    _, psynth = synths
    seq = np.random.default_rng(6).integers(70, 146, size=14).astype(np.int32)
    want, mel_len, _ = psynth.synthesize_ids(seq)
    monkeypatch.setattr(infer, "KERNEL_MIN_FRAMES", 0)
    monkeypatch.setattr(psynth, "vocoder_mode", "folded_kernel")
    folded_matmul.launches = mrf_block.launches = 0
    got, mel_len_k, _ = psynth.synthesize_ids(seq)
    assert folded_matmul.launches == mrf_block.launches == 0
    assert mel_len_k == mel_len
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
